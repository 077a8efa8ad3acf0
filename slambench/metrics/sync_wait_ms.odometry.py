"""Host milliseconds a window frame blocked in odometry's counted syncs,
mean over the window: ``info["trace"]["wait_ms"]`` under the keys
``sync.odometry.<site>``; the traced run's stage synchronise
(``stage.odometry``) is left out."""


def read(run):
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    if not reports:
        return None
    return sum(sum(ms for key, ms in r["wait_ms"].items() if key.startswith("sync.odometry."))
               for r in reports) / len(reports)
