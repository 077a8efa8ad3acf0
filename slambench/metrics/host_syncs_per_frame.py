"""Host syncs a window frame, mean over the window: every blocking device
read, upload and data-dependent torch call the program counted in the
frame's report (``info["trace"]["counts"]``, keys ``sync.<stage>.<site>``),
the traced run's stage synchronises (``sync.stage``) left out."""


def read(run):
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    if not reports:
        return None
    return sum(sum(n for key, n in r["counts"].items()
                   if key.startswith("sync.") and key != "sync.stage")
               for r in reports) / len(reports)
