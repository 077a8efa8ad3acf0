"""Multi-device execution of the port over ``torch.distributed``, one process
per rank: the data-parallel mapping loop and mesher (``mesh.py``), the
process-group bring-up on one or several nodes (``distributed.py``), the
global map sharded across ranks (``spatial.py``) and the launcher the tests
and chip_smoke start their ranks with (``launch.py``)."""
