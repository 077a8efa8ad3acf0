"""Milliseconds of a bundle-adjustment iteration over the window: the
program's ``pin_slam.pgo.ba.loop`` spans (the Adam loop, synchronised at
its end in the traced run) over the reports' ``ba.iters`` counts.  None
where no BA ran."""


def read(run):
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    iters = sum(r["counts"].get("ba.iters", 0) for r in reports)
    if not iters:
        return None
    return sum(r["span_ms"].get("pin_slam.pgo.ba.loop", 0.0) for r in reports) / iters
