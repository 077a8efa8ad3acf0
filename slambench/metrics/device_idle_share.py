"""The share of the traced frames' wall time in which no operation ran on
the device, in percent (torch.profiler, the union of the device operations'
intervals)."""


def read(run):
    t = run.trace
    if not t or t.get("window_s", 0) <= 0 or t.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
