"""Host syncs a window frame in the odometry stage, mean over the window:
the counts ``sync.odometry.<site>`` of the frame's report
(``info["trace"]``): the tracker's packed normal-equation fetch, its pose
uploads, the source cloud's counts, the pose selection's reads."""


def read(run):
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    if not reports:
        return None
    return sum(sum(n for key, n in r["counts"].items() if key.startswith("sync.odometry."))
               for r in reports) / len(reports)
