"""The guards: JAX modules by whole top-level name."""

from __future__ import annotations

import _tiny  # noqa: F401

from benchmark.harness import guard


def test_whole_top_level_names():
    names = ["mysteryann_tpu_torch", "mysteryann_tpu_torch.flat",
             "mysteryann_tpu", "mysteryann_tpu.flat", "jax", "jax.numpy",
             "jaxlib.xla_client", "flax.linen", "jaxtyping", "flaxen",
             "torch", "numpy", "mysteryann_tpu_extra"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "mysteryann_tpu", "mysteryann_tpu.flat"]


def test_the_harness_and_port_load_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.harness import runner, guard\n"
            "import mysteryann_tpu_torch, mysteryann_tpu_torch.flat\n"
            "import mysteryann_tpu_torch.search.fused\n"
            "print(guard.forbidden_modules())" % _tiny.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
