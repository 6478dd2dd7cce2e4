"""The agent network in plain PyTorch: the CRNN of the MARL-DMFB reference
(a 3x3 VALID conv stack over the field of view, a 10-wide MLP over the
direction and last-action vector, a GRU cell and a Q head), written from
its equations over a dict of weights.

The weights are named as the measured program names its parameters, so
that the benchmark can hand one set, drawn from its seed, to both sides.
:func:`make_weights` draws them on the device in one call, each tensor
U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# stride of each 3x3 conv per field of view (reference ``conv_str``)
CONV_STRIDES = {5: (1,), 7: (1, 1), 9: (1, 1), 11: (1, 1), 13: (1, 1),
                19: (2, 1, 1)}
MLP_WIDTH = 10


def conv_sizes(fov: int) -> list:
    """The side of the image after each conv."""
    sizes, size = [], fov
    for s in CONV_STRIDES[fov]:
        size = (size - 3) // s + 1
        sizes.append(size)
    return sizes


def input_dim(cfg: dict) -> int:
    """One agent's net input: the pixels, the 2-vector, the last action."""
    return (cfg["obs_channels"] * cfg["fov"] ** 2 + 2
            + (cfg["n_actions"] if cfg["last_action"] else 0))


def weight_spec(cfg: dict) -> dict:
    """``{name: (shape, fan_in)}`` of every weight of the net of ``cfg``
    (``obs_channels``, ``fov``, ``conv_channels``, ``rnn_hidden``,
    ``n_actions``, ``last_action``)."""
    C, ch, H, A = (cfg["obs_channels"], cfg["conv_channels"],
                   cfg["rnn_hidden"], cfg["n_actions"])
    spec, cin = {}, C
    for i, _ in enumerate(CONV_STRIDES[cfg["fov"]]):
        spec[f"convs.{i}.weight"] = ((ch, cin, 3, 3), cin * 9)
        spec[f"convs.{i}.bias"] = ((ch,), cin * 9)
        cin = ch
    vec = 2 + (A if cfg["last_action"] else 0)
    spec["mlp1.weight"] = ((MLP_WIDTH, vec), vec)
    spec["mlp1.bias"] = ((MLP_WIDTH,), vec)
    gru_in = conv_sizes(cfg["fov"])[-1] ** 2 * ch + MLP_WIDTH
    spec["gru.weight_ih"] = ((3 * H, gru_in), H)
    spec["gru.weight_hh"] = ((3 * H, H), H)
    spec["gru.bias_ih"] = ((3 * H,), H)
    spec["gru.bias_hh"] = ((3 * H,), H)
    spec["fc1.weight"] = ((A, H), H)
    spec["fc1.bias"] = ((A,), H)
    return spec


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight of the net, drawn in one call from a generator on
    ``device`` seeded with ``seed``: float32, U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""
    spec = weight_spec(cfg)
    total = sum(math.prod(shape) for shape, _ in spec.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, (shape, fan_in) in spec.items():
        n = math.prod(shape)
        out[name] = (flat[at:at + n] / math.sqrt(fan_in)).view(shape)
        at += n
    return out


def forward(w: dict, x: torch.Tensor, h: torch.Tensor, cfg: dict):
    """One step on rows ``x`` (R, input_dim) with hidden ``h`` (R, H):
    returns the Qs (R, n_actions) and the new hidden state."""
    C, fov = cfg["obs_channels"], cfg["fov"]
    n_pix = C * fov * fov
    pix = x[:, :n_pix].reshape(-1, C, fov, fov)
    for i, s in enumerate(CONV_STRIDES[fov]):
        pix = F.relu(F.conv2d(pix, w[f"convs.{i}.weight"],
                              w[f"convs.{i}.bias"], stride=s))
    vec = F.relu(x[:, n_pix:] @ w["mlp1.weight"].t() + w["mlp1.bias"])
    z = torch.cat([pix.flatten(1), vec], dim=-1)
    gi = z @ w["gru.weight_ih"].t() + w["gru.bias_ih"]
    gh = h @ w["gru.weight_hh"].t() + w["gru.bias_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    u = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h = (1.0 - u) * n + u * h
    return h @ w["fc1.weight"].t() + w["fc1.bias"], h


def unroll(w: dict, inputs: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The net over time: ``inputs`` (b, T, N, input_dim) -> Qs
    (b, T, N, n_actions), the hidden state starting at zero."""
    b, T, N = inputs.shape[:3]
    h = inputs.new_zeros((b * N, cfg["rnn_hidden"]))
    qs = []
    for t in range(T):
        q, h = forward(w, inputs[:, t].reshape(b * N, -1), h, cfg)
        qs.append(q.view(b, N, -1))
    return torch.stack(qs, dim=1)
