"""The heavy frames' time: the 99th percentile of every window frame's
time, from its ``preprocess_frame`` call to the synchronise after
``process_frame``.  Where heavy frames (closures) are 1 in 20, it falls
among them, not on their edge as the 95th percentile does."""

import numpy as np


def read(run):
    if not run.frame_s:
        return None
    return float(np.percentile(np.asarray(run.frame_s) * 1e3, 99))
