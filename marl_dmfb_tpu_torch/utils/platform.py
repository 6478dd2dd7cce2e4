"""The torch device and the precision rules of the port.

The JAX reference computes the nets in full float32, or under
``--compute_dtype bf16`` multiplies bfloat16 operands with float32
accumulation (the MXU's).  cuDNN runs convolutions in TF32 unless told
otherwise, and cuBLAS may reduce bf16 split-K partial sums in bf16, which
changes greedy argmax decisions and the learner's gradients, so every place
that runs a net on CUDA calls :func:`disable_tf32`: the trainer, the
learner, the rollout and the entry points through :func:`select_device`.
"""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Turn off TF32 in cuDNN's convolutions and cuBLAS's matmuls, and
    cuBLAS's bf16 reductions of bf16 matmuls, so that they accumulate in
    float32 (process-wide flags, with no effect on the CPU)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def select_device(name: str) -> torch.device:
    """The torch device for ``--device``; raises instead of falling back
    when CUDA is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available here; pass "
            "--device cpu to run the plain versions on the CPU")
    disable_tf32()
    return device
