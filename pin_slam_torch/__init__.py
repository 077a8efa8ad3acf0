"""pin_slam_torch: the PyTorch/CUDA port of pin_slam_tpu (neural-point
implicit LiDAR SLAM) for NVIDIA Hopper GPUs.

The JAX package ``pin_slam_tpu`` is the reference; this package imports
nothing from it (nor from JAX).  Entry point:
``pin_slam_torch.slam.pipeline.SlamSystem``.
"""
