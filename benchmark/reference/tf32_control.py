"""The control of the T2I configurations: the reference put in the
program's place, computed one precision below what the configurations state.

The configurations state float32 distances with TF32 off; the step below is
TF32. This engine answers every call with the exact top-k of
``exact_topk`` over operands rounded to TF32, and returns the TF32
distances. The comparison that decides ``correct`` has to find it wrong
(``benchmark/tools/control.py --mode reference_tf32`` reads it on the chip;
``tests/test_benchmark_control.py`` at a small size on the CPU).

It has the engine adapters' interface, so the harness drives it through the
same loop and the same comparison as the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.exact_topk import exact_topk, tf32


class Engine:
    """Exact search in TF32 in the program's place."""

    def __init__(self, config: dict, world, device, log=print):
        self.metric = config["world"]["metric"]
        self.k = int(config["serve"]["k"])
        self.base = tf32(world.base)
        self.setup_parts: dict = {}
        self.spans: dict = {}

    def search(self, q):
        ids, dists = exact_topk(tf32(q), self.base, self.k, self.metric)
        return ids.to(torch.int32), dists

    def reset_counters(self) -> None:
        pass

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.base = None
