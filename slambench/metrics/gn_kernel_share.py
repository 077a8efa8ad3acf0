"""Share of the Gauss-Newton steps that the track-step kernel served, over
the window: the frames' ``launches["track_step"]`` (the kernel's launch
count in the program's report) over their packed normal-equation fetches
``sync.odometry.gn_fetch`` + ``sync.pgo.gn_fetch`` (every step, kernel or
torch, reads one).  None where the program has no such kernel or no step
ran."""


def read(run):
    from pin_slam_torch.ops import _cuda

    if "track_step" not in _cuda.COUNTS:
        return None
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    fetches = sum(r["counts"].get("sync.odometry.gn_fetch", 0)
                  + r["counts"].get("sync.pgo.gn_fetch", 0) for r in reports)
    if not fetches:
        return None
    return sum(r["launches"].get("track_step", 0) for r in reports) / fetches
