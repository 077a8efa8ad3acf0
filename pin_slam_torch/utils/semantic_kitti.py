"""SemanticKITTI label utilities, the port's copy of
``pin_slam_tpu/utils/semantic_kitti.py``: raw label ids -> the 20 learning
classes, their names, and their colour map."""

from __future__ import annotations

import numpy as np

# raw label id -> learning id (0 = unlabeled / outlier), per the SemanticKITTI API
SEM_KITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6, 31: 7,
    32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0, 60: 9, 70: 15,
    71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7, 254: 6, 255: 8,
    256: 5, 257: 5, 258: 4, 259: 5,
}

SEM_KITTI_CLASS_NAMES = [
    "unlabeled", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]

SEM_KITTI_COLOR_MAP = np.asarray([
    [0, 0, 0], [245, 150, 100], [245, 230, 100], [150, 60, 30], [180, 30, 80],
    [255, 0, 0], [30, 30, 255], [200, 40, 255], [90, 30, 150], [255, 0, 255],
    [255, 150, 255], [75, 0, 75], [75, 0, 175], [0, 200, 255], [50, 120, 255],
    [0, 175, 0], [0, 60, 135], [80, 240, 150], [150, 240, 255], [0, 0, 255],
], dtype=np.uint8)


def apply_learning_map(raw_labels: np.ndarray) -> np.ndarray:
    """Raw SemanticKITTI ids (the lower 16 bits) -> the 20 learning classes."""
    lut = np.zeros(260, dtype=np.int32)
    for k, v in SEM_KITTI_LEARNING_MAP.items():
        lut[k] = v
    return lut[np.clip(raw_labels, 0, 259)]


def labels_to_colors(learning_labels: np.ndarray) -> np.ndarray:
    """Learning labels -> RGB uint8 colours."""
    return SEM_KITTI_COLOR_MAP[np.clip(learning_labels, 0, 19)]
