"""Process-group bring-up on one or several nodes, torch counterpart of
``pin_slam_tpu/parallel/distributed.py``.

The port runs one process per rank (what ``torchrun`` launches):

* every rank runs the same SLAM pipeline on the same sensor stream, so the
  dataset, the pose books, the pose graph and the map stay replicated and
  bit-identical (every collective whose result is replicated gives every
  rank the same bits, and every other draw advances identically);
* the training batch is split over the ranks of the data mesh, ordered
  node-major (all ranks of node 0, then node 1, ...), so that a ring over
  the mesh crosses each node boundary once;
* only collectives cross ranks: the gradient all-reduce, the mesher's gather
  of query results and the map shards' gathers (``spatial.py``).

Backends: NCCL on CUDA devices, gloo on the CPU.  ``PIN_SLAM_DIST_BACKEND=
gloo`` asks for gloo on CUDA devices, and only then may several ranks of a
node share one GPU.  Under NCCL rank ``LOCAL_RANK`` runs on
``cuda:LOCAL_RANK``, and ``initialize`` makes it the process's current
device (the kernels' ctypes launches go to the current device's stream).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

BACKEND_ENV = "PIN_SLAM_DIST_BACKEND"
DEFAULT_TIMEOUT_S = 1800.0
LAUNCH = ("PIN_SLAM_DIST=1 torchrun --nproc-per-node {n} -m pin_slam_torch.cli "
          "<config.yaml> ...")


@dataclasses.dataclass(frozen=True)
class RankInfo:
    rank: int
    world: int
    local_rank: int
    nodes: Tuple[int, ...]    # node index of every global rank
    backend: str
    device: torch.device


_INFO: Optional[RankInfo] = None


def backend_for(device_type: str) -> str:
    """NCCL on CUDA, gloo on the CPU, unless ``PIN_SLAM_DIST_BACKEND`` names
    one; NCCL on the CPU is refused."""
    name = os.environ.get(BACKEND_ENV, "")
    if not name:
        return "nccl" if device_type == "cuda" else "gloo"
    if name not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV}={name!r}: expected 'nccl' or 'gloo'")
    if name == "nccl" and device_type != "cuda":
        raise ValueError(f"{BACKEND_ENV}=nccl needs CUDA devices; the CPU runs gloo")
    return name


def _rank_device(device, backend: str, local_rank: int) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank needs a CUDA device; pass device='cpu' to run "
                           "the ranks on the CPU under gloo")
    n = torch.cuda.device_count()
    idx = dev.index if dev.index is not None else local_rank
    if backend == "nccl" and idx >= n:
        raise RuntimeError(
            f"LOCAL_RANK {local_rank} has no GPU of its own ({n} visible): NCCL runs one "
            f"rank a GPU; start at most {n} ranks a node, or share GPUs under "
            f"{BACKEND_ENV}=gloo")
    idx %= n
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               local_rank: Optional[int] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the process group when a multi-process launch is configured.

    Sources, in order:
      1. the explicit arguments;
      2. ``PIN_SLAM_COORDINATOR`` (``host:port``, ``tcp://...`` or
         ``file://...``) / ``PIN_SLAM_NUM_PROCESSES`` (> 1) /
         ``PIN_SLAM_PROCESS_ID``; the local rank is ``LOCAL_RANK`` if set,
         else the process id;
      3. ``PIN_SLAM_DIST=1``: torchrun's ``RANK`` / ``WORLD_SIZE`` /
         ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``.

    ``device``: None runs the rank on its GPU, ``"cpu"`` on the CPU.  A
    node is told apart by torchrun's ``GROUP_RANK``, else by its host name.
    Returns True once the group is up (also when it already was), False
    (doing nothing) when no launch is configured."""
    global _INFO
    if _INFO is not None:
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("PIN_SLAM_COORDINATOR")
    if num_processes is None:
        num_processes = int(env.get("PIN_SLAM_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(env.get("PIN_SLAM_PROCESS_ID", "-1") or -1)
    if coordinator_address and num_processes > 1 and process_id >= 0:
        init_method, world, rank = _init_method(coordinator_address), num_processes, process_id
        lr = local_rank if local_rank is not None else int(env.get("LOCAL_RANK", process_id))
    elif env.get("PIN_SLAM_DIST", "0") == "1":
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in env]
        if missing:
            raise RuntimeError(f"PIN_SLAM_DIST=1 without {missing}: launch with {LAUNCH.format(n='N')}")
        init_method, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
        lr = local_rank if local_rank is not None else int(env.get("LOCAL_RANK", "0"))
    else:
        return False
    dev_type = torch.device("cuda" if device is None else device).type
    backend = backend_for(dev_type)
    dev = _rank_device(device, backend, lr)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    keys = [None] * world
    dist.all_gather_object(keys, env.get("GROUP_RANK") or socket.gethostname())
    first = {}
    for r, k in enumerate(keys):
        first.setdefault(k, r)
    order = sorted(first, key=first.get)
    _INFO = RankInfo(rank=rank, world=world, local_rank=lr,
                     nodes=tuple(order.index(k) for k in keys), backend=backend, device=dev)
    return True


def info() -> Optional[RankInfo]:
    """This process's rank, world, node layout, backend and device (None
    without a process group)."""
    return _INFO


def shutdown() -> None:
    """Destroy the process group (no-op without one)."""
    global _INFO
    if _INFO is not None:
        dist.destroy_process_group()
        _INFO = None


def host_count() -> int:
    return 1 if _INFO is None else len(set(_INFO.nodes))


def require_world(n: int, what: str) -> RankInfo:
    """The rank info of a group of exactly ``n`` ranks, else an error that
    names the launch: ``what`` needs ``n`` processes, and never runs on
    fewer."""
    if _INFO is None:
        raise RuntimeError(f"{what} needs {n} processes, one a rank, and no process group "
                           f"was started: launch with {LAUNCH.format(n=n)}")
    if _INFO.world != n:
        raise RuntimeError(f"{what} needs {n} ranks, and the process group has "
                           f"{_INFO.world}: launch with {LAUNCH.format(n=n)}")
    return _INFO


def make_global_mesh(n_devices: Optional[int] = None, device=None):
    """The data mesh over every rank of every node, node-major: all ranks of
    node 0, then node 1, ...  Without a process group and for
    ``n_devices`` None or 1 it is the one-rank mesh on ``device`` (None:
    the GPU), which runs no collective.  Raises, naming the launch, when the
    group's size is not ``n_devices``."""
    from pin_slam_torch.parallel import mesh as pmesh

    if _INFO is None and (n_devices or 1) == 1:
        return pmesh.single_mesh(device)
    inf = require_world(n_devices or (_INFO.world if _INFO else 1),
                        f"a data mesh of {n_devices} devices")
    order = tuple(sorted(range(inf.world), key=lambda r: (inf.nodes[r], r)))
    return pmesh.Mesh(group=None, rank=order.index(inf.rank), size=inf.world,
                      device=inf.device, ranks=order, backend=inf.backend)
