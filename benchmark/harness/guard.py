"""The process-level guards of a run: the card it asks for, and no JAX.

The JAX package (``mysteryann_tpu``) is the port's reference on the CPU and
is never measured. A module counts by its top-level name, the part before
the first dot, compared whole: ``mysteryann_tpu_torch`` is the port and
passes, ``mysteryann_tpu.flat`` does not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mysteryann_tpu"})


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_modules(names: Iterable[str] | None = None) -> List[str]:
    """The names among ``names`` (default: ``sys.modules``) whose top-level
    name is a forbidden one, sorted."""
    names = sys.modules.keys() if names is None else names
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def device_problem(chips: int) -> str | None:
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
    return None


def outside(root: str, package: str,
            modules: dict | None = None) -> List[str]:
    """The loaded modules of ``package`` whose file is not under ``root``:
    the program measured is the one in the checkout, never an installed
    copy."""
    import os

    modules = sys.modules if modules is None else modules
    root = os.path.join(os.path.realpath(root), "")
    out = []
    for name, mod in list(modules.items()):
        path = getattr(mod, "__file__", None)
        if top_level(name) == package and path and not \
                os.path.realpath(path).startswith(root):
            out.append(name)
    return sorted(out)
