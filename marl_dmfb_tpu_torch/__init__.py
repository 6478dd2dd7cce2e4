"""marl_dmfb_tpu_torch — the PyTorch/CUDA port of ``marl_dmfb_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  It imports
``torch`` and ``numpy`` only; the JAX package is the reference that the
tests hold it against.  It trains, evaluates and sweeps for electrode wear
(``eva_degrade``) DMFB policies (v0 int8 and v0.1 float32 observations,
CRNN or RNN agents in float32 or bf16, VDN), its own or the JAX package's
exported by ``tools/export_flax_npz.py``: the env step runs through the
hand-written CUDA kernel in ``csrc/dmfb_step.cu`` on the card and through
its plain PyTorch version on the CPU.
"""

__version__ = "0.1.0"
