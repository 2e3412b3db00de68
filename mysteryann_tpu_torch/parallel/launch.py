"""One SPMD runner: spawn the ranks of a multi-rank run on this host.

The counterpart of calling a ``jit(shard_map(...))`` from one controller in
the JAX package: `run` starts ``world`` processes (``torch.multiprocessing``,
start method ``spawn``), each with the environment a launcher such as
``torchrun`` gives a rank (``MASTER_ADDR`` / ``MASTER_PORT`` on a free local
port, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and one
CPU thread for torch, since the ranks share the host's cores. Each rank
imports the function named ``"module:function"``, calls it, and sends back
what it returns; the function joins the process group itself
(``parallel.make_mesh_distributed``) and the runner tears the group down.

Failure is never swallowed: any rank's exception, a rank that dies, or a
rank still running at ``timeout`` (one hung in a collective) fails the call
with ``RuntimeError`` / ``TimeoutError``, and every rank still alive is
killed.
"""

from __future__ import annotations

import importlib
import os
import pickle
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from typing import Any, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, local_world: int, fn: str,
               call_path: str, results) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world))
    torch.set_num_threads(1)
    try:
        with open(call_path, "rb") as f:
            args = pickle.load(f)
        mod, name = fn.split(":")
        out = getattr(importlib.import_module(mod), name)(*args)
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn: str, world: int, args: Sequence = (), *, timeout: float,
        local_world: int | None = None) -> List[Any]:
    """Run ``fn`` (``"module:function"``) in ``world`` spawned ranks and
    return each rank's result, by rank. ``local_world`` ranks make a host
    (default: all of them), which sets ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``. Arguments and results cross processes by pickle:
    pass and return numpy arrays, not tensors. Raises ``TimeoutError`` after ``timeout`` seconds and ``RuntimeError``
    when a rank fails, after killing the ranks still alive."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        # the arguments go through a file: a process's start blocks until
        # the child has read what its pipe carries, and a child reads that
        # only after importing torch, so large arguments in the pipe would
        # start the ranks one after the other
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump(tuple(args), f)
        port = free_port()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, port, local_world or world, fn, call_path, results))
            for r in range(world)]
        for p in procs:
            p.start()
        return _collect(fn, procs, results, timeout)


def _collect(fn: str, procs: list, results, timeout: float) -> List[Any]:
    """Each rank's result, by rank; kills every rank still alive when one
    fails or the time is up."""
    out: List[Any] = [None] * len(procs)
    pending = set(range(len(procs)))
    deadline = time.monotonic() + timeout
    try:
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn}: ranks {sorted(pending)} still "
                                   f"running after {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 2.0))
            except queue_mod.Empty:
                # a rank that died without a word (killed, crashed); one
                # that exited 0 has sent its result and it is on its way
                dead = [r for r in sorted(pending)
                        if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"{fn}: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and sent no result")
                continue
            if not ok:
                raise RuntimeError(f"{fn}: rank {rank} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
    finally:
        for p in procs:
            if pending and p.is_alive():
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return out
