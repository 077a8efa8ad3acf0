"""The dataset layer's milliseconds a frame, mean over the window: the
host's ``SLAMDataset.preprocess_frame`` (crop, cap, deskew) plus the
upload that opens ``process_frame`` (``stage_times[:, 0]``, synchronised in
the traced run)."""

import numpy as np


def read(run):
    if run.stage_s is None or not run.dataset_s:
        return None
    return float((np.mean(run.dataset_s) + np.mean(run.stage_s[:, 0])) * 1e3)
