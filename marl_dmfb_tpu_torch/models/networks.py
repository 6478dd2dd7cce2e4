"""Agent networks and the VDN and QMIX mixers in PyTorch (JAX
``models/networks.py:27-315``).

The JAX package wrote torch's layers again in Flax (``TorchGRUCell``,
``TorchDense``, ``TorchConv``) to keep the reference's gate math and init;
here they are torch's own layers under the same names.  Parameters are
initialised U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from an explicit generator
(:func:`init_params`), the scheme both packages share.

The agent input keeps the JAX package's flat layout,
``[pixel (C*fov*fov) | direction (2) | last-action one-hot (n_actions)]``,
and the conv output is flattened channel-major, as there.

``--compute_dtype bf16`` is the JAX package's mixed precision
(``networks.py:30-37, 100-119``): each matmul and conv casts both operands
to bfloat16 and upcasts the product to float32, and the bias is added in
float32 after the upcast; the parameters, the GRU gates' nonlinearities and
everything between the layers stay float32.  XLA compiles that cast pair
away (its default ``xla_allow_excess_precision``): the JAX package's
product is the float32 sum of the exact products of the bfloat16-rounded
operands, never rounded to bfloat16.  The port computes the same thing, a
float32 matmul or conv of operands rounded to bfloat16 (:func:`_round`).
In float32 every layer is torch's own.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32."""
    return x.to(dtype).float()


def _linear(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w.T`` of the operands rounded to ``dtype``, in float32 (JAX
    ``_mm`` as XLA compiles it)."""
    return F.linear(_round(x, dtype), _round(w, dtype))


class TorchDense(nn.Linear):
    """torch's Linear; in ``compute_dtype`` the operands are rounded there
    and the bias added in float32 (JAX ``TorchDense``)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return _linear(x, self.weight, self.compute_dtype) + self.bias


class TorchGRUCell(nn.GRUCell):
    """torch's GRUCell (r/z/n gates, reset inside the candidate's hidden
    branch); in ``compute_dtype`` the operands of the two gate products are
    rounded there and the gates computed in float32 (JAX
    ``TorchGRUCell``).

    ``stacked`` (set by :func:`stackable`) computes the float32 cell from
    its two gate products and elementwise ops, in the order of torch's
    fused cell, instead of calling it: ``aten::gru_cell`` has no
    ``torch.func.vmap`` batching rule, so under the seed farm's vmap over
    stacked parameters it would run once per seed."""

    def __init__(self, input_size: int, hidden_size: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(input_size, hidden_size)
        self.compute_dtype = compute_dtype
        self.stacked = False

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            if not self.stacked:
                return super().forward(x, h)
            gi = F.linear(x, self.weight_ih, self.bias_ih)
            gh = F.linear(h, self.weight_hh, self.bias_hh)
            i_r, i_z, i_n = gi.chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(h_r + i_r)
            z = torch.sigmoid(h_z + i_z)
            n = torch.tanh(i_n + h_n * r)
            return (h - n) * z + n
        gi = _linear(x, self.weight_ih, dt) + self.bias_ih
        gh = _linear(h, self.weight_hh, dt) + self.bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    def sequence(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 cell run over a whole sequence from a zero state in
        one call of torch's sequence GRU (cuDNN's on a card): ``x`` ``(T,
        R, input_size)`` -> every step's hidden state ``(T, R,
        hidden_size)``.  torch's GRU and GRUCell share the gate order and
        equations (``b_hn`` inside ``r * (...)``), so this is the cell's
        loop to float32 rounding.  The call takes the cell's own
        parameters, so their gradients are the cell's, and the optimizer,
        the EMA and the target sync see one set; cuDNN then packs them
        into its buffer on each call (a copy of the cell's weights), and
        its warning that it does so is silenced."""
        h0 = x.new_zeros((1, x.shape[1], self.hidden_size))
        weights = [self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh]
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "RNN module weights are not")
            out, _ = torch._VF.gru(x, h0, weights, True, 1, 0.0,
                                   torch.is_grad_enabled(), False, False)
        return out


class TorchConv(nn.Conv2d):
    """VALID 3x3 convolution (NCHW); in ``compute_dtype`` the operands are
    rounded there and the bias is added in float32 (JAX ``TorchConv``)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, kernel_size=3, stride=stride)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv2d(_round(x, dt), _round(self.weight, dt), None,
                     self.stride)
        return y + self.bias[:, None, None]


COMPUTE_DTYPES = {"float32": None, "bf16": torch.bfloat16}


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

    def __init__(self, input_dim: int, n_actions: int, rnn_hidden: int = 128,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.fc1 = TorchDense(input_dim, rnn_hidden, dt)
        self.gru = TorchGRUCell(rnn_hidden, rnn_hidden, dt)
        self.fc2 = TorchDense(rnn_hidden, n_actions, dt)

    def forward(self, inputs: torch.Tensor, h: torch.Tensor):
        h = self.gru(F.relu(self.fc1(inputs)), h)
        return self.fc2(h), h

    def encode(self, inputs: torch.Tensor) -> torch.Tensor:
        """The GRU's input, which reads no hidden state."""
        return F.relu(self.fc1(inputs))

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The Q head on hidden states."""
        return self.fc2(h)


class CRNNAgent(nn.Module):
    """Conv stack over the FOV image + MLP over the direction/last-action
    vector -> GRU -> Q head (JAX networks.py:171-224)."""

    def __init__(self, n_actions: int, obs_channels: int, fov: int,
                 conv_channels: int, rnn_hidden: int = 128, vec_len: int = 2,
                 last_action: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.obs_channels = obs_channels
        self.fov = fov
        in_ch = obs_channels
        self.convs = nn.ModuleList()
        for stride in conv_plan(fov):
            self.convs.append(TorchConv(in_ch, conv_channels, stride, dt))
            in_ch = conv_channels
        self.mlp1 = TorchDense(vec_len + (n_actions if last_action else 0),
                               10, dt)
        out = conv_out_size(fov)
        self.gru = TorchGRUCell(out * out * conv_channels + 10, rnn_hidden,
                                dt)
        self.fc1 = TorchDense(rnn_hidden, n_actions, dt)

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

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The Q head on hidden states."""
        return self.fc1(h)


def runs_as_sequence(net) -> bool:
    """Whether ``net`` is an RNN or CRNN agent module whose GRU cell is
    torch's own float32 cell (:meth:`TorchGRUCell.sequence` computes the
    same): not bf16, which rounds each step's ``W_hh h`` operands, and not
    in the ``stacked`` form, as cuDNN's sequence GRU has no ``vmap``
    batching rule."""
    return (isinstance(net, (RNNAgent, CRNNAgent))
            and net.gru.compute_dtype is None and not net.gru.stacked)


def stackable(module: nn.Module) -> nn.Module:
    """``module`` with every GRU cell in its ``stacked`` form, so that
    ``torch.func.vmap`` over stacked parameters batches each of its
    operations across the seeds; returns the module."""
    for m in module.modules():
        if isinstance(m, TorchGRUCell):
            m.stacked = True
    return module


class StackedNet:
    """An agent net called on S stacked parameter sets at once (the seed
    farm's rollouts): ``params`` maps the net's parameter names to tensors
    with a first axis of S, read when called, so updates in place show.
    Rows are seed-major, ``(S*R, .)``: seed i's R rows run through its
    parameters, by ``torch.func.vmap`` of ``functional_call`` over the
    seeds (one batched operation for each of the net's)."""

    def __init__(self, net: nn.Module, params: dict, n_seeds: int):
        self.params = params
        self.n_seeds = n_seeds
        net = stackable(net)
        self._forward = torch.func.vmap(
            lambda p, x, h: torch.func.functional_call(net, p, (x, h)))

    def __call__(self, x: torch.Tensor, h: torch.Tensor):
        return self.apply(self.params, x, h)

    def apply(self, params: dict, x: torch.Tensor, h: torch.Tensor):
        """The call on the stacked ``params`` instead of :attr:`params`."""
        S = self.n_seeds
        q, h = self._forward(params, x.reshape(S, -1, x.shape[-1]),
                             h.reshape(S, -1, h.shape[-1]))
        return q.flatten(0, 1), h.flatten(0, 1)


def build_agent_net(args) -> nn.Module:
    """Pick the agent net from config (JAX networks.py:237-259), in
    ``args.compute_dtype`` (float32, or bf16 mixed precision).  The input
    ends with the last action's one-hot unless ``args.last_action`` is
    off."""
    n_last = args.n_actions if args.last_action else 0
    dt = COMPUTE_DTYPES[getattr(args, "compute_dtype", "float32")]
    if args.net == "rnn":
        return RNNAgent(input_dim=args.obs_shape[-1] + n_last,
                        n_actions=args.n_actions,
                        rnn_hidden=args.rnn_hidden_dim, compute_dtype=dt)
    if args.net == "crnn":
        return CRNNAgent(
            n_actions=args.n_actions,
            obs_channels=args.obs_shape[0],
            fov=args.fov,
            conv_channels=args.hyper_hidden_dim,
            rnn_hidden=args.rnn_hidden_dim,
            vec_len=args.obs_shape[-2],
            last_action=args.last_action,
            compute_dtype=dt,
        )
    raise ValueError(f"unknown net: {args.net!r}")


def vdn_mix(agent_qs: torch.Tensor) -> torch.Tensor:
    """Additive joint Q: sum over the agent axis (dim 2), kept."""
    return agent_qs.sum(dim=2, keepdim=True)


class QMixer(nn.Module):
    """The state-conditioned monotonic mixer (JAX ``QMixer``,
    networks.py:281-315; reference ``QMixNet``): hypernetworks of the
    global state give the weights of a one-hidden-layer mix of the agents'
    Qs, made non-negative by ``abs``, with ELU on the hidden layer.  With
    ``two_hyper_layers`` the weight hypernetworks have a ReLU hidden layer
    of ``hyper_hidden``.  The layers keep the JAX package's names and are
    float32 whatever the agent's ``compute_dtype``, as there."""

    def __init__(self, n_agents: int, state_dim: int, qmix_hidden: int = 32,
                 hyper_hidden: int = 32, two_hyper_layers: bool = True):
        super().__init__()
        self.n_agents, self.state_dim = n_agents, state_dim
        self.qmix_hidden = qmix_hidden
        self.two_hyper_layers = two_hyper_layers
        H = qmix_hidden
        if two_hyper_layers:
            self.hyper_w1_1 = TorchDense(state_dim, hyper_hidden)
            self.hyper_w1_2 = TorchDense(hyper_hidden, n_agents * H)
            self.hyper_w2_1 = TorchDense(state_dim, hyper_hidden)
            self.hyper_w2_2 = TorchDense(hyper_hidden, H)
        else:
            self.hyper_w1 = TorchDense(state_dim, n_agents * H)
            self.hyper_w2 = TorchDense(state_dim, H)
        self.hyper_b1 = TorchDense(state_dim, H)
        self.hyper_b2_1 = TorchDense(state_dim, H)
        self.hyper_b2_2 = TorchDense(H, 1)

    def forward(self, agent_qs: torch.Tensor,
                states: torch.Tensor) -> torch.Tensor:
        """``agent_qs`` (b, T, N), ``states`` (b, T, state_dim) float32 ->
        the joint Q (b, T, 1)."""
        b, T, n = agent_qs.shape
        q = agent_qs.reshape(-1, 1, n)
        s = states.reshape(-1, self.state_dim)
        if self.two_hyper_layers:
            w1 = self.hyper_w1_2(F.relu(self.hyper_w1_1(s)))
            w2 = self.hyper_w2_2(F.relu(self.hyper_w2_1(s)))
        else:
            w1, w2 = self.hyper_w1(s), self.hyper_w2(s)
        b1 = self.hyper_b1(s)
        b2 = self.hyper_b2_2(F.relu(self.hyper_b2_1(s)))
        w1 = w1.abs().view(-1, n, self.qmix_hidden)
        w2 = w2.abs().view(-1, self.qmix_hidden, 1)
        hidden = F.elu(torch.bmm(q, w1) + b1[:, None, :])
        q_total = torch.bmm(hidden, w2) + b2[:, None, :]
        return q_total.view(b, T, 1)


def build_mixer(args) -> Optional[QMixer]:
    """The QMIX mixer for ``--alg qmix`` (JAX qlearn.py:118-128), else None
    (VDN sums the agents' Qs, :func:`vdn_mix`)."""
    if args.alg != "qmix":
        return None
    return QMixer(n_agents=args.n_agents, state_dim=args.state_shape,
                  qmix_hidden=args.qmix_hidden_dim,
                  hyper_hidden=args.hyper_hidden_dim,
                  two_hyper_layers=args.two_hyper_layers)
