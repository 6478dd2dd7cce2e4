"""Fixtures of the benchmark's own tests (``python3 -m pytest
benchmark/tests`` from the root; on the card, with ``-m cuda``)."""

import pytest
import torch


@pytest.fixture
def cuda():
    """The card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists on the card only")
    return "cuda"
