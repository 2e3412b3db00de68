"""`TimeMetric` of the port (``mysteryann_tpu_torch/utils/timers.py``)
against the JAX package's, under one scripted clock: equal totals, the same
error for ``record()`` before ``reset()``, the same ``print`` line."""

import time

import pytest

from mysteryann_tpu.utils import timers as jax_timers
from mysteryann_tpu_torch.utils import TimeMetric
from mysteryann_tpu_torch.utils import timers as torch_timers

# reset/record pairs: 2.5 s, then 0.25 s, then 1e-6 s
TICKS = [1.0, 3.5, 10.0, 10.25, 20.0, 20.000001]


def _scripted(monkeypatch, module):
    """``time.perf_counter`` as ``module`` sees it, stepping through TICKS."""
    it = iter(TICKS)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


def _drive(cls, name, n_pairs):
    m = cls(name)
    for _ in range(n_pairs):
        m.reset()
        m.record()
    return m


@pytest.mark.parametrize("n_pairs", [1, 2, 3])
def test_totals_and_print_equal_the_jax_class(n_pairs, monkeypatch, capsys):
    out = {}
    for key, module in (("jax", jax_timers), ("torch", torch_timers)):
        with monkeypatch.context() as mp:
            _scripted(mp, module)
            m = _drive(module.TimeMetric, "phase", n_pairs)
        m.print()
        out[key] = (m.total, capsys.readouterr().out)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == pytest.approx(
        sum(TICKS[2 * i + 1] - TICKS[2 * i] for i in range(n_pairs)))
    assert out["torch"][1].startswith("[TimeMetric] phase: ")


def test_record_before_reset_raises_as_the_jax_class():
    errors = []
    for cls in (jax_timers.TimeMetric, TimeMetric):
        m = cls("x")
        with pytest.raises(RuntimeError) as e:
            m.record()
        errors.append(str(e.value))
        # a record() consumes its reset(): a second one raises again
        m.reset()
        m.record()
        with pytest.raises(RuntimeError):
            m.record()
    assert errors[0] == errors[1] == "record() before reset()"


def test_is_the_exported_class_and_real_clock():
    assert TimeMetric is torch_timers.TimeMetric
    m = TimeMetric()
    m.reset()
    time.sleep(0.002)
    m.record()
    assert m.total >= 0.002 and m.name == ""
