"""The training stage's host milliseconds a window frame less its waits,
mean over the window: the ``pin_slam.training`` span of the frame's report
(``info["trace"]["span_ms"]``) less ``wait_ms`` of its counted syncs
(``sync.training.<site>``) and of the stage's synchronise
(``stage.training``): the enqueue and Python cost of the training calls."""


def read(run):
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    if not reports:
        return None
    busy = 0.0
    for r in reports:
        waits = sum(ms for key, ms in r["wait_ms"].items()
                    if key.startswith("sync.training.") or key == "stage.training")
        busy += r["span_ms"].get("pin_slam.training", 0.0) - waits
    return busy / len(reports)
