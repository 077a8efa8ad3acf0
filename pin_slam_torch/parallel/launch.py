"""Start the ranks of a multi-process run on this machine, one process each,
and wait for all of them: the launcher the port's multi-process tests and
chip_smoke's two-process phases share (a real deployment starts its ranks
with ``torchrun``).

    python -m pin_slam_torch.parallel.launch <module>:<function> [argument]

is what each child runs: it imports ``module`` and calls
``function(argument)``, which brings the process group up itself through
``distributed.initialize()`` from the environment ``spawn`` gave it, and
destroys the group when the function returns.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_RANK_VARS = ("PIN_SLAM_DIST", "PIN_SLAM_COORDINATOR", "PIN_SLAM_NUM_PROCESSES",
              "PIN_SLAM_PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK", "GROUP_RANK",
              "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int, rank: int, *, mode: str, rendezvous: str,
             nodes: Optional[Sequence[int]] = None) -> Dict[str, str]:
    """The variables that tell rank ``rank`` of ``world`` how to join:
    ``mode`` "file" (``PIN_SLAM_COORDINATOR`` = ``rendezvous``, a
    ``file://`` path or a ``host:port``, with ``PIN_SLAM_NUM_PROCESSES`` /
    ``PIN_SLAM_PROCESS_ID``; world > 1) or "torchrun" (``PIN_SLAM_DIST=1``
    with torchrun's variables, ``rendezvous`` = the master port).  ``nodes``
    (a node index per rank, default all 0) sets ``GROUP_RANK`` and makes
    the local ranks count within each node."""
    nodes = list(nodes) if nodes is not None else [0] * world
    local = sum(1 for r in range(rank) if nodes[r] == nodes[rank])
    env = {"LOCAL_RANK": str(local), "GROUP_RANK": str(nodes[rank])}
    if mode == "file":
        env.update(PIN_SLAM_COORDINATOR=rendezvous, PIN_SLAM_NUM_PROCESSES=str(world),
                   PIN_SLAM_PROCESS_ID=str(rank))
    elif mode == "torchrun":
        env.update(PIN_SLAM_DIST="1", RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(rendezvous))
    else:
        raise ValueError(f"mode {mode!r}")
    return env


def spawn(world: int, target: str, arg: str = "", *, mode: str = "file",
          workdir: Optional[str] = None, env: Optional[Dict[str, str]] = None,
          timeout: float = 600.0, pythonpath: Sequence[str] = (),
          nodes: Optional[Sequence[int]] = None,
          threads: Optional[int] = None) -> List[str]:
    """Run ``target`` (``module:function``) with ``arg`` in ``world`` child
    processes that join one process group (``rank_env``; the file
    rendezvous lives in ``workdir``, default a new temporary directory).
    ``env`` is added to each child's environment, ``pythonpath`` put in
    front of the repository root on its path, ``threads`` sets
    ``OMP_NUM_THREADS``; the children run from the repository root.  Waits
    for all of them; when one exits non-zero, or ``timeout`` seconds pass,
    every child still running is killed and RuntimeError raised with the
    output of each.  Returns each child's output (stdout and stderr
    together)."""
    workdir = workdir or tempfile.mkdtemp(prefix="pin_slam_ranks_")
    os.makedirs(workdir, exist_ok=True)
    rdzv = (f"file://{os.path.join(workdir, f'rdzv_{os.getpid()}_{time.time_ns()}')}"
            if mode == "file" else str(free_port()))
    base = {k: v for k, v in os.environ.items() if k not in _RANK_VARS}
    base["PYTHONPATH"] = os.pathsep.join(
        [*pythonpath, ROOT] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    if threads:
        base["OMP_NUM_THREADS"] = str(threads)
    procs, logs = [], []
    try:
        for r in range(world):
            e = {**base, **(env or {}), **rank_env(world, r, mode=mode, rendezvous=rdzv,
                                                    nodes=nodes)}
            log = open(os.path.join(workdir, f"rank{r}_{os.getpid()}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pin_slam_torch.parallel.launch", target, arg],
                stdout=log, stderr=subprocess.STDOUT, env=e, cwd=ROOT))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout:.0f} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed:
        raise RuntimeError(f"{target} over {world} ranks: {failed}\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode}) ---\n{o[-4000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


def _main(argv: List[str]) -> int:
    import importlib

    target, arg = argv[1], (argv[2] if len(argv) > 2 else "")
    mod, fn = target.split(":")
    try:
        getattr(importlib.import_module(mod), fn)(arg)
    finally:
        from pin_slam_torch.parallel import distributed as pdist

        pdist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv))
