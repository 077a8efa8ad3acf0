"""Milliseconds of one pass over the replay pool's rows after a pose change:
the program's ``pin_slam.pgo.deform.pool`` (a loop closure's) and
``pin_slam.pgo.ba.pool`` (a bundle adjustment's) spans, each ending in the
``sync_stages`` synchronise in the traced run, over the reports'
``pool.passes`` counts.  None where no pass ran, or where the program has no
such count."""


def read(run):
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    passes = sum(r["counts"].get("pool.passes", 0) for r in reports)
    if not passes:
        return None
    return sum(r["span_ms"].get("pin_slam.pgo.deform.pool", 0.0)
               + r["span_ms"].get("pin_slam.pgo.ba.pool", 0.0) for r in reports) / passes
