"""Milliseconds a frame of the pipeline's training stage, mean over the
window: ``SlamSystem.stage_times[:, 3]``, synchronised at each stage's end in
the traced run (``sync_stages=True``)."""

import numpy as np


def read(run):
    if run.stage_s is None:
        return None
    return float(np.mean(run.stage_s[:, 3]) * 1e3)
