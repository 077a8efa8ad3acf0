"""Milliseconds a window frame of the dataset's deskew, mean over the
window's frames that carry the program's report: the span
``pin_slam.dataset.deskew`` (the uploads of the points, their times and the
motion, the slerp and the read-back, inside ``pin_slam.dataset.preprocess``,
carried into the frame's ``info["trace"]``).  None where no frame
deskewed."""


def read(run):
    reports = [inf["trace"] for inf in run.infos if "trace" in inf]
    ms = [r["span_ms"].get("pin_slam.dataset.deskew") for r in reports]
    if not any(v is not None for v in ms):
        return None
    return sum(v or 0.0 for v in ms) / len(reports)
