"""The benchmark of ``pin_slam_torch`` on one H100: ``python3 slambench/run.py``."""
