"""Distances — batched matmuls in float32.

Port of ``mysteryann_tpu/ops/distances.py``. The reference's per-pair SIMD
``Distance::compare(a, b, dim)`` (reference include/efanna2e/distance.h:
39-225) becomes a batched ``[B, d] @ [d, C]`` product; that is where nearly
all of the system's FLOPs are, at build and at query time.

Conventions preserved from the reference:
- inner product is returned NEGATED so that smaller = better for every
  metric (reference distance.h:223);
- L2 is the *squared* euclidean distance (no sqrt — ordering-equivalent,
  reference distance.h:39-89);
- cosine = normalize once, then negated inner product
  (reference src/index.cpp:16-19 + src/index_bipartite.cpp:176-182).

Precision, set once here for the whole package: float32 matmuls run in full
float32 on the card — TF32 is off for matmuls and for cuDNN — so distances
and the exact kNN ground truth agree with the JAX package's float32
results (its ``precision="highest"``). The ``precision`` arguments kept for
call-site parity therefore change nothing. Scores of bf16 operands are f32,
as the JAX package's ``preferred_element_type=float32`` makes them (a plain
``bf16 @ bf16`` in torch would return bf16-rounded scores).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Metric(enum.Enum):
    """Reference Metric enum {L2, INNER_PRODUCT, COSINE} (distance.h:15)."""

    L2 = "l2"
    IP = "ip"
    COSINE = "cosine"

    @classmethod
    def parse(cls, s: "Metric | str") -> "Metric":
        if isinstance(s, Metric):
            return s
        s = s.lower()
        for m in cls:
            if m.value == s:
                return m
        aliases = {"inner_product": cls.IP, "euclidean": cls.L2}
        if s in aliases:
            return aliases[s]
        raise ValueError(f"unknown metric {s!r}")


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization (reference util.h:215-237)."""
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """||x_i||^2 per row — precomputable for the L2 expansion.

    A bf16 input gives a bf16 norm formed as the JAX package's compiled
    ``pairwise_dist`` forms it: f32 products of the bf16 values, an f32
    sum, one rounding to bf16."""
    if x.dtype == torch.bfloat16:
        xf = x.float()
        return torch.sum(xf * xf, dim=-1).to(torch.bfloat16)
    return torch.sum(x * x, dim=-1)


def _ip_f32(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``q @ b.T`` with an f32 result. For bf16 operands it is what
    ``preferred_element_type=float32`` gives: a bf16 × bf16 product is exact
    in f32, so each operand (the caller's tile, never a whole resident
    table) is upcast and the f32 matmul (TF32 off) accumulates."""
    if q.dtype == torch.float32 and b.dtype == torch.float32:
        return q @ b.transpose(-1, -2)
    return q.float() @ b.float().transpose(-1, -2)


def pairwise_dist(
    q: torch.Tensor,
    b: torch.Tensor,
    metric: Metric = Metric.IP,
    b_sqnorm: torch.Tensor | None = None,
    precision: str = "default",
) -> torch.Tensor:
    """All-pairs distances ``[Bq, Cb]`` between query block and base block,
    in float32 for float32 or bf16 inputs.

    For COSINE the inputs are assumed pre-normalized (do it once at load,
    like the reference normalizes the dataset up front rather than inside
    the kernel — src/index_bipartite.cpp:176-182).
    """
    metric = Metric.parse(metric)
    ip = _ip_f32(q, b)
    if metric in (Metric.IP, Metric.COSINE):
        return -ip
    # L2: ||q||^2 - 2 q.b + ||b||^2 ; ||q||^2 is rank-preserving per query but
    # kept so absolute values match the reference's squared-L2 outputs.
    qn = squared_norms(q)[..., None].float()
    bn = (squared_norms(b) if b_sqnorm is None else b_sqnorm).float()
    return torch.clamp(qn - 2.0 * ip + bn[None, :], min=0.0)


def point_dist(
    a: torch.Tensor,
    b: torch.Tensor,
    metric: Metric = Metric.IP,
    precision: str = "default",
) -> torch.Tensor:
    """Row-wise distance between aligned batches ``[B, d] x [B, d] -> [B]``."""
    metric = Metric.parse(metric)
    ip = torch.sum(a * b, dim=-1)
    if metric in (Metric.IP, Metric.COSINE):
        return -ip
    diff_sq = squared_norms(a) - 2.0 * ip + squared_norms(b)
    return torch.clamp(diff_sq, min=0.0)


def array_device(device: torch.device | str | None = None) -> torch.device:
    """Where an array (not a tensor) goes: ``device`` when given, else the
    first CUDA device. The port runs on the card unless the caller asks
    for the CPU, so without a card this raises instead of falling back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def prepare_vectors(x, metric: Metric | str,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """Apply the metric's one-time preprocessing (cosine → normalize) and
    place the rows as float32 on ``device`` (default: ``x``'s own device
    for a tensor, the card for an array — see `array_device`)."""
    metric = Metric.parse(metric)
    if isinstance(x, torch.Tensor):
        x = x.to(device=device if device is not None else x.device,
                 dtype=torch.float32)
    else:
        dev = array_device(device)
        x = np.ascontiguousarray(x, dtype=np.float32)
        if not x.flags.writeable:   # torch.from_numpy wants writable memory
            x = x.copy()
        x = torch.from_numpy(x).to(dev)
    if metric == Metric.COSINE:
        x = normalize_rows(x)
    return x.contiguous()
