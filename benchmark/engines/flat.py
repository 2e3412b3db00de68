"""Engine adapter: exact brute-force serving by the port's ``FlatIndex``.

Set-up makes the index (a bf16 copy of the base beside the f32 rows) after
the kernels are built and loaded. A call is ``FlatIndex.search(...,
device_out=True)``: the bf16 scan fused with the selection of a
k·oversample head (K3f), then the exact f32 rerank of the head through the
row gather (K1).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import torch

from benchmark.harness.runner import sync


def build_kernels(device: torch.device) -> float:
    """Compile (unless built) and load the port's kernels; seconds."""
    if device.type != "cuda":
        return 0.0
    from mysteryann_tpu_torch.ops import gather, score_select, select
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(m.build) for m in (gather, select, score_select)]:
            f.result()
    return time.perf_counter() - t0


class Engine:
    def __init__(self, config: dict, world, device: torch.device, log=print):
        from mysteryann_tpu_torch.flat import FlatIndex

        s = config["serve"]
        self.k = int(s["k"])
        kernels_s = build_kernels(device)
        sync(device)
        t0 = time.perf_counter()
        self.index = FlatIndex(world.base, metric=config["world"]["metric"],
                               precision=s["precision"],
                               oversample=int(s["oversample"]))
        sync(device)
        self.setup_parts = {"kernels_s": kernels_s,
                            "index_s": time.perf_counter() - t0}
        self.spans: dict = {}
        log(f"flat index {self.setup_parts['index_s']:.2f}s")

    def search(self, q: torch.Tensor):
        return self.index.search(q, self.k, query_batch=q.shape[0],
                                 device_out=True)

    def reset_counters(self) -> None:
        pass

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.index = None
