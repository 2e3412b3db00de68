"""Multi-key sorts and index-ordered selection with JAX's semantics.

The JAX package leans on two XLA primitives that PyTorch has no direct
counterpart for:

- ``lax.sort(operands, num_keys=K)``: a stable sort ordered
  lexicographically by the first K operands, the rest riding along.
  ``torch.sort`` takes one key. ``sort_multi`` packs pairs of 32-bit keys
  into one int64 key and runs stable sorts from the least significant pair
  up, which gives the same order.
- ``lax.top_k``: among equal values the lowest index comes first.
  ``torch.topk`` promises no order among ties. ``topk_smallest`` selects on
  the composite (value, index) key, which is unique, so the chosen set and
  its order are those of ``-lax.top_k(-x, k)``. On the card the key is
  compared by the k-selection kernel K3 (``ops/select.py``); on the CPU
  ``torch.topk`` takes it (``topk_smallest_ref``).

Float keys are compared through an order-preserving int32 image of their
bits. ``-0.0`` is first turned into ``+0.0``: JAX's sort and an IEEE
comparison treat the two as equal, a bit pattern would not. (``lax.top_k``
orders by the total order, ``-0.0`` before ``+0.0``: where a row mixes the
two zeros, ``topk_smallest`` keeps them in column order instead.)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_SHIFT = 1 << 32
_BIAS = 1 << 31


def order_key(x: torch.Tensor) -> torch.Tensor:
    """An int32 tensor that orders like ``x`` (bool, int32 or float32)."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    if x.dtype.is_floating_point:
        bits = (x.to(torch.float32) + 0.0).view(torch.int32)
        return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"unsupported sort key dtype {x.dtype}")
    return x.to(torch.int32)


def pack_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordering lexicographically by (hi, lo), both int32 images."""
    return hi.to(torch.int64) * _SHIFT + (lo.to(torch.int64) + _BIAS)


def sort_multi(operands: Sequence[torch.Tensor], num_keys: int = 1
               ) -> Tuple[torch.Tensor, ...]:
    """``lax.sort(operands, dimension=-1, num_keys=num_keys)``: stable,
    lexicographic on the first ``num_keys`` operands."""
    keys = [order_key(o) for o in operands[:num_keys]]
    perm = None
    i = len(keys)
    while i > 0:
        if i >= 2:
            k = pack_keys(keys[i - 2], keys[i - 1])
            i -= 2
        else:
            k = keys[0]
            i -= 1
        if perm is not None:
            k = k.gather(-1, perm)
        _, p = torch.sort(k, dim=-1, stable=True)
        perm = p if perm is None else perm.gather(-1, p)
    return tuple(o.gather(-1, perm) for o in operands)


def topk_smallest_ref(x: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``topk_smallest``: ``torch.topk`` of the
    composite key ``pack_keys(order_key(x), column)``."""
    # pack_keys(order_key(x), position), built in place: at the kNN tile
    # sizes the key is the largest temporary of the selection
    key = order_key(x).to(torch.int64)
    key.mul_(_SHIFT).add_(torch.arange(_BIAS, _BIAS + x.shape[-1],
                                       dtype=torch.int64, device=x.device))
    _, idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return x.gather(-1, idx), idx


def topk_smallest(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` smallest entries along the last dim,
    ascending, ties broken by lower index — ``-lax.top_k(-x, k)``, with
    ``-0.0`` and ``+0.0`` equal (see the module docstring).

    A CPU tensor takes the plain version (``topk_smallest_ref``); a CUDA
    tensor the k-selection kernel K3 (``ops/select.py``), which returns the
    same bits."""
    if x.device.type == "cpu":
        return topk_smallest_ref(x, k)
    from mysteryann_tpu_torch.ops.select import topk_smallest_cuda
    return topk_smallest_cuda(x, k)


# bytes the plain version holds beside each element of its input: the int32
# order image, the int64 composite key and torch.topk's scratch
_REF_BYTES_PER_ELEM = 32


def selection_bytes(device: torch.device) -> int:
    """Bytes of temporaries ``topk_smallest`` holds per element of its input
    on ``device``: the plain version's on the CPU, none on the card, where
    K3 forms its keys in registers."""
    return _REF_BYTES_PER_ELEM if device.type == "cpu" else 0
