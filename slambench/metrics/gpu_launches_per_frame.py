"""Device operations (kernels, copies, sets) per traced frame, from
torch.profiler."""


def read(run):
    t = run.trace
    if not t or not t.get("device_ops"):
        return None
    return t["device_ops"] / t["n_frames"]
