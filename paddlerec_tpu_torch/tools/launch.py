"""Multi-process launcher: the ``fleetrun`` / ``run_gpubox.sh`` analog of the
port (``paddlerec_tpu/tools/launch.py``).

Spawns ``nproc`` copies of a command on this machine, rank ``r`` with the
``torch.distributed`` variables ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, the backend in
``PADDLEREC_DIST_BACKEND`` (``nccl``, the default, or ``gloo`` for ranks on
the CPU or ranks that share a card), and the reference's role
variables ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM`` and
``TRAINING_ROLE``.  A child joins the group with ``init_from_env(device)``.
The device is the caller's choice, apart from the backend: the card unless
the CPU is asked for, rank ``r`` on card ``LOCAL_RANK % device_count()``.
So gloo ranks may share one card (NCCL refuses two ranks on one GPU), and
an entry point's ``--device`` rides in the command after ``--`` untouched.
The launcher returns the first non-zero exit code of a child, and then
stops the others, which would wait for it in a collective.

Usage:
    python -m paddlerec_tpu_torch.tools.launch --nproc 2 --backend gloo \
        [--timeout SECONDS] -- python my_script.py
    python -m paddlerec_tpu_torch.tools.launch --nproc 4 --backend gloo -- \
        python -m paddlerec_tpu_torch.tools.train -m configs/rank/deepfm/config.yaml \
        -o runner.mesh_dp=2 runner.mesh_mp=2 [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

BACKEND_VAR = "PADDLEREC_DIST_BACKEND"


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, cmd: Sequence[str], backend: str = "nccl",
           port: Optional[int] = None, timeout: Optional[float] = None) -> int:
    """Run ``cmd`` as ``nproc`` ranks and wait for all of them.  Returns 0,
    or the exit code of the first child to fail (the rest are then
    stopped); ``timeout`` seconds stops them all, with code 124."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, not {backend!r}")
    port = port or free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update({
            "RANK": str(rank), "WORLD_SIZE": str(nproc), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            BACKEND_VAR: backend,
            # role env vars kept for reference-compatible scripts
            "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(nproc),
            "TRAINING_ROLE": "TRAINER",
        })
        procs.append(subprocess.Popen(list(cmd), env=env))
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            if None not in codes:
                break
            if deadline is not None and time.monotonic() > deadline:
                rc = 124
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


def init_from_env(device=None, timeout_s: float = 120.0):
    """Join the process group the launcher set up: the backend, address,
    rank and world size from the environment.  ``device`` is the caller's
    (``None`` or ``"cuda"``: the card, ``cuda:(LOCAL_RANK % device_count)``,
    which raises without one; ``"cpu"``: the CPU), whatever the backend.
    Returns the ``torch.device`` of the rank."""
    import torch
    import torch.distributed as dist

    from paddlerec_tpu_torch.core.device import resolve_device

    backend = os.environ.get(BACKEND_VAR, "nccl")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def launched() -> bool:
    """Whether this process is a rank of a launch of more than one
    (``WORLD_SIZE`` > 1 in the environment)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def main(argv=None):
    parser = argparse.ArgumentParser(description="multi-process launcher")
    parser.add_argument("--nproc", type=int, default=1)
    parser.add_argument("--backend", default="nccl", choices=("gloo", "nccl"),
                        help="nccl: one card a rank (default); gloo: ranks on the CPU, "
                             "or several ranks on one card")
    parser.add_argument("--port", type=int, default=0,
                        help="MASTER_PORT (default: a free port)")
    parser.add_argument("--timeout", type=float, default=None,
                        help="seconds after which every rank is stopped (exit code 124)")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- command to launch")
    args = parser.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        parser.error("no command given (put it after --)")
    return launch(args.nproc, cmd, args.backend, args.port or None, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
