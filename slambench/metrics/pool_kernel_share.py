"""Share of the passes over the replay pool's rows that the pool-pass kernel
served, over the window: the reports' ``launches["pool_pass"]`` (the
kernel's launch count in the program's report) over their ``pool.passes``
counts (every pass, kernel or torch, adds one).  None where no pass ran, or
where the program has no such count."""


def read(run):
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    passes = sum(r["counts"].get("pool.passes", 0) for r in reports)
    if not passes:
        return None
    return sum(r["launches"].get("pool_pass", 0) for r in reports) / passes
