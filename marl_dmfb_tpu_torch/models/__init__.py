"""Agent Q-networks and the VDN mixer (PyTorch)."""

from marl_dmfb_tpu_torch.models.networks import (
    CRNNAgent,
    RNNAgent,
    build_agent_net,
    vdn_mix,
)

__all__ = ["CRNNAgent", "RNNAgent", "build_agent_net", "vdn_mix"]
