"""Biochip routing environments, batched over chips, in PyTorch."""

from marl_dmfb_tpu_torch.envs import dmfb, meda
from marl_dmfb_tpu_torch.envs.registry import Env, make_env

__all__ = ["dmfb", "meda", "Env", "make_env"]
