"""Batch command-line driver of the PyTorch port, the counterpart of
``pin_slam_tpu/cli.py``:

    python -m pin_slam_torch.cli <config.yaml> [dataset_name] [sequence] [seed]
        [--frames N] [--device cuda|cpu]

``dataset_name`` and ``sequence`` point the profile at a sequence under the
dataset root given as the profile's ``pc_path`` (``dataset/indexing.py``).
The run goes to ``<output_root>/<name>_<timestamp>/`` (``meta/run.json``, the
trajectory and its evaluation, the map, the mesh as the profile asks) and
ends with one summary line, also written to ``summary.json``.  It runs on
the GPU unless ``--device cpu`` is given.

Several processes (``dp_devices > 1``, ``map_shards > 1``):

    PIN_SLAM_DIST=1 torchrun --nproc-per-node N -m pin_slam_torch.cli <config.yaml> ...

brings the process group up first (``parallel/distributed.py``; also from
``PIN_SLAM_COORDINATOR`` / ``PIN_SLAM_NUM_PROCESSES`` /
``PIN_SLAM_PROCESS_ID``); every rank runs the same frames and rank 0 alone
writes the run directory and the summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="pin_slam_torch batch SLAM driver")
    ap.add_argument("config", help="YAML config profile")
    ap.add_argument("dataset_name", nargs="?", default="",
                    help="dataset name for path indexing (kitti, mulran, ncd128, ...)")
    ap.add_argument("sequence", nargs="?", default="", help="sequence id, e.g. 00")
    ap.add_argument("seed", nargs="?", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None, help="limit frame count")
    ap.add_argument("--device", default=None,
                    help="torch device: the GPU by default, 'cpu' only when named")
    args = ap.parse_args(argv)

    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.indexing import set_dataset_path
    from pin_slam_torch.parallel import distributed as pdist

    cfg = Config().load(args.config)
    if args.seed is not None:
        cfg.seed = args.seed
    if args.dataset_name:
        set_dataset_path(cfg, args.dataset_name, args.sequence)
    # multi-process bring-up (nothing without a configured launch)
    started = pdist.info() is None and pdist.initialize(device=args.device)
    try:
        return _run(args, argv, cfg)
    finally:
        if started:
            pdist.shutdown()


def _run(args, argv, cfg) -> int:
    """The run on this rank (the only one without a process group); rank 0
    alone makes the run directory and writes the summary."""
    from pin_slam_torch.parallel import distributed as pdist
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils.experiment import setup_experiment

    inf = pdist.info()
    writer = inf is None or inf.rank == 0
    if inf is not None:
        print(f"[pin_slam_torch] torch.distributed: rank {inf.rank}/{inf.world} "
              f"({inf.backend}, {inf.device})")
    run_path = None
    if writer:
        run_path = setup_experiment(cfg, argv=list(argv) if argv is not None else sys.argv[1:])
        print(f"[pin_slam_torch] run dir: {run_path}")
    if inf is not None and inf.world > 1:
        from pin_slam_torch.parallel import mesh as pmesh

        run_path = pmesh.broadcast_object(pmesh.make_mesh(inf.world), run_path)
        if not writer:
            setup_experiment(cfg, create=False)
            cfg.run_path = run_path

    t0 = time.time()
    system = SlamSystem(cfg, device=args.device)
    cfg.device = system.device.type
    if writer:
        print(f"[pin_slam_torch] device: {system.device}")
    if len(system.dataset) == 0:
        print(f"[pin_slam_torch] no frames found under {cfg.pc_path}", file=sys.stderr)
        return 2
    system.run(num_frames=args.frames)
    if not writer:
        return 0
    wall = time.time() - t0
    n = system.frame_id
    summary = {"frames": n, "wall_s": round(wall, 1),
               "frames_per_s": round(n / max(wall, 1e-9), 2), **system.metrics}
    print("[pin_slam_torch] " + json.dumps(summary))
    with open(os.path.join(run_path, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
