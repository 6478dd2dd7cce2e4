"""marl_dmfb_tpu_torch — the PyTorch/CUDA port of ``marl_dmfb_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  It imports
``torch`` and ``numpy`` only; the JAX package is the reference that the
tests hold it against.  This slice covers evaluation and the actor rollout
of the DMFB environment (v0 int8 observation, CRNN agents, VDN): the env
step runs through the hand-written CUDA kernel in ``csrc/dmfb_step.cu`` on
the card and through its plain PyTorch version on the CPU.
"""

__version__ = "0.1.0"
