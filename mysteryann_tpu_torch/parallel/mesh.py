"""Device mesh helpers on torch.distributed.

Port of ``mysteryann_tpu/parallel/mesh.py``. The scaling axes are the JAX
package's:

- ``dp`` (data parallel): independent queries sharded across ranks — the
  analogue of the reference's query fan-out
  (tests/test_search_roargraph.cpp:203-209);
- ``mp`` (model parallel): the base-vector table and the adjacency
  row-sharded across the ranks' device memory — for corpora larger than one
  card.

JAX drives a mesh of devices from one controller and runs a ``shard_map``
body on each. PyTorch's idiom is one process per rank: every rank runs what
that body runs, on its own shards, and the collectives ride process groups
over the mesh axes, taken from a ``DeviceMesh`` with dims ``("dp", "mp")``
and ``mp`` laid along consecutive ranks. JAX's ``lax.psum(x, "mp")``
becomes `psum` (``dist.all_reduce`` on the ``mp`` group), its
``lax.all_gather`` becomes `all_gather` (``dist.all_gather_into_tensor``).

Backends (`init_distributed`): ``nccl`` when each rank has a card of its
own, ``gloo`` on the CPU, and ``cpu:gloo,cuda:gloo`` when ranks share a card
(NCCL refuses two ranks on one device). On a gloo backend the collective
helpers copy CUDA tensors to host memory, run the collective there and copy
the result back, so every collective takes gloo's CPU path whatever CUDA
support the installed torch's gloo has.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "mp")
# torch >= 2.13 names the tensor all-gather all_gather_single and deprecates
# the older name, which is the only one earlier versions have
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class Mesh:
    """A ``dp x mp`` mesh of ranks as seen from one rank: the mesh's
    ``shape`` (``{"dp": .., "mp": ..}``), this rank's coordinate on each
    axis, the axis process groups and the rank's ``device``."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend
        self.shape: Dict[str, int] = {a: device_mesh.size(i)
                                      for i, a in enumerate(AXES)}
        self._coord = dict(zip(AXES, device_mesh.get_coordinate()))
        self._groups = {a: device_mesh.get_group(a) for a in AXES}
        # gloo collectives run on host copies of CUDA tensors (module doc)
        self.stage = device.type == "cuda" and "nccl" not in backend

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self._coord[axis]

    def group(self, axis: str):
        """The process group of this rank's peers along ``axis``."""
        return self._groups[axis]


def _axes(axis) -> Tuple[str, ...]:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}")
    return axes


def rank_device(device: torch.device | str | None = None) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:{LOCAL_RANK % device_count}``. The port runs on the card unless
    asked for the CPU, so without a card this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device=\"cpu\" to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device, local_ranks: int) -> str:
    """The process-group backend for ranks on ``device``, ``local_ranks``
    of them on this host: gloo on the CPU; nccl when each rank has a card
    of its own; gloo for both device types when ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    if local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "cpu:gloo,cuda:gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: torch.device | str | None = None) -> None:
    """Join (or start) the process group of a multi-rank run.

    Thin, idempotent wrapper over ``dist.init_process_group`` with
    ``init_method=f"tcp://{coordinator}"``. Arguments left ``None`` come from
    the environment a launcher (``torchrun``, ``parallel.launch``) sets:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ranks per host
    from ``LOCAL_WORLD_SIZE`` (default: all of them). The backend follows
    from those and ``device`` (`backend_for`). A second call with a live
    group is a no-op. Every process must then call `make_mesh` with
    identical arguments.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("init_distributed needs a coordinator "
                             "(host:port) or MASTER_ADDR / MASTER_PORT")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    dev = rank_device(device)
    local = int(env.get("LOCAL_WORLD_SIZE", str(num_processes)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev, local),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def make_mesh(dp: int = 1, mp: int = 1, devices: Sequence[int] | None = None,
              allow_split_mp: bool = False,
              device: torch.device | str | None = None) -> Mesh | None:
    """``dp x mp`` mesh over the ranks ``devices`` (default: all ranks of
    the process group), with ``mp`` packed along consecutive ranks.

    Consecutive ranks share a host (launchers number ranks host by host),
    so filling ``mp`` first keeps the per-hop psums (neighbour rows and
    partial distances) inside a host, and lets ``dp`` — which never
    communicates during a search — span hosts. An ``mp`` axis that would
    straddle hosts (ranks per host from ``LOCAL_WORLD_SIZE``) is refused
    unless ``allow_split_mp=True``.

    Must be called by every rank of the process group (it creates the axis
    groups); a rank outside ``devices[:dp*mp]`` gets ``None``.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = (list(range(world)) if devices is None
               else [int(r) for r in devices])
    if dp * mp > len(devices):
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, "
                         f"have {len(devices)}")
    use = devices[: dp * mp]
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if not allow_split_mp and any(
            len({r // per_host for r in use[i * mp: (i + 1) * mp]}) > 1
            for i in range(dp)):
        raise ValueError(
            f"mp={mp} would straddle hosts ({per_host} devices/host): "
            "per-hop psums would cross hosts. Lay mp within a host, or "
            "pass allow_split_mp=True if the corpus truly exceeds one "
            "host's memory.")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed (or make_mesh_distributed)")
    dev = rank_device(device)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if use == list(range(world)):
        dm = init_device_mesh(dev.type, (dp, mp), mesh_dim_names=AXES)
    else:
        dm = DeviceMesh(dev.type, torch.tensor(use).reshape(dp, mp),
                        mesh_dim_names=AXES)
    if dist.get_rank() not in use:
        return None
    return Mesh(dm, dev, str(dist.get_backend()))


def make_mesh_distributed(dp: int = 0, mp: int = 1,
                          coordinator: str | None = None,
                          num_processes: int | None = None,
                          process_id: int | None = None,
                          device: torch.device | str | None = None) -> Mesh:
    """Multi-host mesh: join the process group, then lay ``mp`` within
    hosts and ``dp`` across them. ``dp=0`` means "all remaining ranks":
    ``dp = world // mp``.

    Traffic (why this layout): per beam expansion the ``mp`` psums move
    ~[B, M]·(4+4) bytes (neighbour row and partial distances) — at B=8192,
    M=32 about 2 MB a hop — traffic for links inside a host; the ``dp``
    axis moves only the [B, k] results, once per batch.
    """
    init_distributed(coordinator, num_processes, process_id, device)
    if dp == 0:
        dp = max(1, dist.get_world_size() // mp)
    return make_mesh(dp=dp, mp=mp, device=device)


def _shard_index(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's shard index, shard count) over ``axes``, major first."""
    idx, size = 0, 1
    for a in axes:
        idx, size = idx * mesh.shape[a] + mesh.coord(a), size * mesh.shape[a]
    return idx, size


def _to_device(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, copy=True, order="C"))
    return x.to(device).contiguous()


def shard_base(mesh: Mesh, x, axis="mp") -> torch.Tensor:
    """This rank's rows of a global ``[N, ...]`` array (numpy — a memmap
    reads only these rows — or a tensor), sharded over ``axis`` (a mesh
    axis or a tuple of them, major first), on the rank's device."""
    axes = _axes(axis)
    idx, size = _shard_index(mesh, axes)
    n = x.shape[0]
    if n % size:
        raise ValueError(f"{'x'.join(axes)} ({size}) must divide the "
                         f"leading dim ({n})")
    s = n // size
    return _to_device(x[idx * s: (idx + 1) * s], mesh.device)


def replicate(mesh: Mesh, x) -> torch.Tensor:
    """The whole array on the rank's device."""
    return _to_device(x, mesh.device)


def psum(x: torch.Tensor, mesh: Mesh, axis="mp",
         op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``x`` may be overwritten);
    ``op`` another reduction (``dist.ReduceOp.MIN``, ...)."""
    y = x.cpu() if mesh.stage else x
    for a in _axes(axis):
        dist.all_reduce(y, op=op, group=mesh.group(a))
    return y.to(x.device) if mesh.stage else y


def all_gather(x: torch.Tensor, mesh: Mesh, axis="mp",
               dim: int = 0) -> torch.Tensor:
    """The shards of ``x`` from the ranks of ``axis`` concatenated along
    ``dim`` in coordinate order (``lax.all_gather(..., tiled=True)``)."""
    axes = _axes(axis)
    y = (x.cpu() if mesh.stage else x).contiguous()
    for a in reversed(axes):      # minor axis first: major-first order
        out = y.new_empty((mesh.shape[a] * y.shape[0],) + y.shape[1:])
        _gather_into(out, y, group=mesh.group(a))
        y = out
    if dim:
        size = math.prod(mesh.shape[a] for a in axes)
        y = y.reshape((size,) + x.shape).movedim(0, dim).reshape(
            x.shape[:dim] + (size * x.shape[dim],) + x.shape[dim + 1:])
    return y.to(x.device)


def gather_dp(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global ``[B, ...]`` result from the dp shards ``x`` [B/dp, ...]."""
    return all_gather(x, mesh, "dp", 0)


def shard_sizes(mesh: Mesh, n_local: int, axis="mp") -> List[int]:
    """Every shard's leading size along ``axis`` (one small all-gather)."""
    t = torch.tensor([n_local], dtype=torch.int64, device=mesh.device)
    return all_gather(t, mesh, axis).tolist()
