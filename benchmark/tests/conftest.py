"""Fixtures of the benchmark's own tests. Run them from the repository's
root: ``python -m pytest benchmark/tests -q``; on the card, the tests marked
``cuda`` run too (``python -m pytest benchmark/tests -q -m cuda``)."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
