"""Agent networks and the VDN mixer in PyTorch (JAX
``models/networks.py:27-278``).

The JAX package wrote torch's layers again in Flax (``TorchGRUCell``,
``TorchDense``, ``TorchConv``) to keep the reference's gate math and init;
here they are torch's own layers under the same names.  Parameters are
initialised U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from an explicit generator
(:func:`init_params`), the scheme both packages share.

The agent input keeps the JAX package's flat layout,
``[pixel (C*fov*fov) | direction (2) | last-action one-hot (n_actions)]``,
and the conv output is flattened channel-major, as there.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


# The JAX package's TorchGRUCell (r/z/n gates, reset inside the candidate's
# hidden branch) and TorchDense are these torch layers.
TorchGRUCell = nn.GRUCell
TorchDense = nn.Linear


class TorchConv(nn.Conv2d):
    """VALID 3x3 convolution (NCHW)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__(in_channels, features, kernel_size=3, stride=stride)


def conv_plan(fov: int) -> Sequence[int]:
    """Stride of each 3x3 conv per FOV (reference ``conv_str``)."""
    plans = {5: (1,), 7: (1, 1), 9: (1, 1), 11: (1, 1), 13: (1, 1),
             19: (2, 1, 1)}
    if fov not in plans:
        raise ValueError(f"no conv plan for fov={fov}")
    return plans[fov]


def conv_out_size(fov: int) -> int:
    size = fov
    for s in conv_plan(fov):
        size = (size - 3) // s + 1
    return size


@torch.no_grad()
def init_params(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from
    ``generator`` (torch's default init, made reproducible): fan_in is the
    input width of a dense layer, in_channels*9 of a conv, and the hidden
    width for every GRU tensor."""
    for module in net.modules():
        if isinstance(module, nn.GRUCell):
            fan_in = module.hidden_size
        elif isinstance(module, nn.Conv2d):
            fan_in = module.in_channels * math.prod(module.kernel_size)
        elif isinstance(module, nn.Linear):
            fan_in = module.in_features
        else:
            continue
        bound = 1.0 / math.sqrt(fan_in)
        for p in module.parameters(recurse=False):
            p.uniform_(-bound, bound, generator=generator)
    return net


class RNNAgent(nn.Module):
    """fc -> GRU -> fc Q head (JAX networks.py:139-168)."""

    def __init__(self, input_dim: int, n_actions: int, rnn_hidden: int = 128):
        super().__init__()
        self.fc1 = TorchDense(input_dim, rnn_hidden)
        self.gru = TorchGRUCell(rnn_hidden, rnn_hidden)
        self.fc2 = TorchDense(rnn_hidden, n_actions)

    def forward(self, inputs: torch.Tensor, h: torch.Tensor):
        h = self.gru(F.relu(self.fc1(inputs)), h)
        return self.fc2(h), h


class CRNNAgent(nn.Module):
    """Conv stack over the FOV image + MLP over the direction/last-action
    vector -> GRU -> Q head (JAX networks.py:171-224)."""

    def __init__(self, n_actions: int, obs_channels: int, fov: int,
                 conv_channels: int, rnn_hidden: int = 128, vec_len: int = 2,
                 last_action: bool = True):
        super().__init__()
        self.obs_channels = obs_channels
        self.fov = fov
        in_ch = obs_channels
        self.convs = nn.ModuleList()
        for stride in conv_plan(fov):
            self.convs.append(TorchConv(in_ch, conv_channels, stride))
            in_ch = conv_channels
        self.mlp1 = TorchDense(vec_len + (n_actions if last_action else 0),
                               10)
        out = conv_out_size(fov)
        self.gru = TorchGRUCell(out * out * conv_channels + 10, rnn_hidden)
        self.fc1 = TorchDense(rnn_hidden, n_actions)

    def encode(self, inputs: torch.Tensor) -> torch.Tensor:
        C, fov = self.obs_channels, self.fov
        pix_len = C * fov * fov
        pixel = inputs[:, :pix_len].reshape(-1, C, fov, fov)
        for conv in self.convs:
            pixel = F.relu(conv(pixel))
        vec = F.relu(self.mlp1(inputs[:, pix_len:]))
        return torch.cat([pixel.flatten(1), vec], dim=-1)

    def forward(self, inputs: torch.Tensor, h: torch.Tensor):
        h = self.gru(self.encode(inputs), h)
        return self.fc1(h), h


def build_agent_net(args) -> nn.Module:
    """Pick the agent net from config (JAX networks.py:237-259; float32
    only: ``compute_dtype=bf16`` is not ported yet).  The input ends with
    the last action's one-hot unless ``args.last_action`` is off."""
    n_last = args.n_actions if args.last_action else 0
    if args.net == "rnn":
        return RNNAgent(input_dim=args.obs_shape[-1] + n_last,
                        n_actions=args.n_actions,
                        rnn_hidden=args.rnn_hidden_dim)
    if args.net == "crnn":
        return CRNNAgent(
            n_actions=args.n_actions,
            obs_channels=args.obs_shape[0],
            fov=args.fov,
            conv_channels=args.hyper_hidden_dim,
            rnn_hidden=args.rnn_hidden_dim,
            vec_len=args.obs_shape[-2],
            last_action=args.last_action,
        )
    raise ValueError(f"unknown net: {args.net!r}")


def vdn_mix(agent_qs: torch.Tensor) -> torch.Tensor:
    """Additive joint Q: sum over the agent axis (dim 2), kept."""
    return agent_qs.sum(dim=2, keepdim=True)
