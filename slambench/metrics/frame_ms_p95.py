"""The hitch: the 95th percentile of every window frame's time, from its
``preprocess_frame`` call to the synchronise after ``process_frame``."""

import numpy as np


def read(run):
    if not run.frame_s:
        return None
    return float(np.percentile(np.asarray(run.frame_s) * 1e3, 95))
