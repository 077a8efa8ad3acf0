"""Gauss-Newton iterations of the odometry registration a tracked frame,
mean over the window's tracked frames that carry the program's report
(``info["trace"]``): their ``reg_iters``, the odometry's own count (loop
verification's iterations are not in it; the report's ``sync.pgo.gn_fetch``
counts those).  A guard: a change to the tracker's host path must hold it
equal."""


def read(run):
    iters = [inf["reg_iters"] for inf in run.infos if "trace" in inf and "reg_iters" in inf]
    if not iters:
        return None
    return sum(iters) / len(iters)
