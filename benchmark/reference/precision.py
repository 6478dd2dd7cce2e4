"""The float32 precision the reference computes in, and the TF32 of its
control: the precision one step below the configurations' float32."""

from __future__ import annotations

import contextlib

import torch


def float32() -> None:
    """Full float32 in cuBLAS's matmuls and cuDNN's convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32():
    """TF32 in cuBLAS's matmuls and cuDNN's convolutions inside the block
    (no effect on the CPU); float32 again after it."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        float32()
