"""QMIX in plain PyTorch: the monotonic mixer of Rashid et al., ICML 2018
(arXiv:1803.11485; MARL-DMFB ``network/qmix_net.py``), the MEDA global
state that conditions it, and the QMIX learner's update (``policy/qmix.py``),
written from their equations over dicts of weights.

For a step's agent Qs q in R^N and its global state s in R^S::

    w1 = |W1b relu(W1a s + c1a) + c1b|    reshaped to (N, H)
    b1 = Wb1 s + cb1
    h  = elu(q^T w1 + b1)
    w2 = |W2b relu(W2a s + c2a) + c2b|    reshaped to (H, 1)
    b2 = Wb2b relu(Wb2a s + cb2a) + cb2b
    Q_tot = h w2 + b2

with one hyper layer (``two_hyper_layers`` off) ``w1 = |W1 s + c1|`` and
``w2 = |W2 s + c2|``.  ``H`` is ``qmix_hidden``, the hyper layers' hidden
width ``hyper_hidden``.

The mixer's weights are named as the measured program names its mixer's
parameters, so that one set, drawn from the seed, goes to both sides.

``cfg`` holds the net's and the learner's values, as :mod:`learner`'s
does, and the mixer's: ``state_dim``, ``qmix_hidden``, ``hyper_hidden``,
``two_hyper_layers``.

Departures from the source repository:

* its QMIX collected no global state (its rollout stores none and its
  env's ``state_shape`` is commented out), so it could not run; the state
  here is the JAX package's MEDA state (``marl_dmfb_tpu/envs/meda.py``,
  ``global_state``): a board of droplet ids and a board of destination
  ids, each cell the largest id whose 5x5 footprint covers it, int8;
* its QMIX gave each agent a one-hot of its id beside the observation; the
  agent here takes the observation and the last action alone, as the VDN
  recipe and the JAX package do;
* every weight is drawn from the seed, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
  in place of torch's default initialisation;
* the update is :mod:`learner`'s (Adam in optax's form, the clip by global
  norm) over the agent's and the mixer's weights together.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from benchmark.reference import meda, net
from benchmark.reference.learner import MASKED_Q, Adam
from benchmark.reference.precision import float32, tf32

MIXER = "mixer."   # the prefix of the mixer's weights among the agent's


def mixer_spec(cfg: dict) -> dict:
    """``{name: (shape, fan_in)}`` of every weight of the mixer."""
    S, N = cfg["state_dim"], cfg["n_droplets"]
    H, Hh = cfg["qmix_hidden"], cfg["hyper_hidden"]
    layers = {}
    if cfg["two_hyper_layers"]:
        layers.update({"hyper_w1_1": (S, Hh), "hyper_w1_2": (Hh, N * H),
                       "hyper_w2_1": (S, Hh), "hyper_w2_2": (Hh, H)})
    else:
        layers.update({"hyper_w1": (S, N * H), "hyper_w2": (S, H)})
    layers.update({"hyper_b1": (S, H), "hyper_b2_1": (S, H),
                   "hyper_b2_2": (H, 1)})
    spec = {}
    for name, (n_in, n_out) in layers.items():
        spec[f"{name}.weight"] = ((n_out, n_in), n_in)
        spec[f"{name}.bias"] = ((n_out,), n_in)
    return spec


def make_mixer_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight of the mixer, drawn in one call from a generator on
    ``device`` seeded with ``seed``: float32, U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""
    spec = mixer_spec(cfg)
    total = sum(math.prod(shape) for shape, _ in spec.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, (shape, fan_in) in spec.items():
        n = math.prod(shape)
        out[name] = (flat[at:at + n] / math.sqrt(fan_in)).view(shape)
        at += n
    return out


def _dense(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """``W x + c`` in one ``F.linear`` call, the bias added inside the
    product as PyTorch computes an affine layer.  The mixer's kinks (the
    ReLUs of the hyper layers, the ``abs`` of the mixing weights) then fall
    on the program's side wherever their inputs agree; a side decided by
    the rounding of a separate bias add would turn a round-off into a
    gradient of the other sign, which Adam's later steps carry into the
    weights."""
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def mix(w: dict, q: torch.Tensor, s: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The joint Q of rows of agent Qs ``q`` (R, N) and states ``s`` (R, S),
    float32: (R,)."""
    N, H = cfg["n_droplets"], cfg["qmix_hidden"]
    if cfg["two_hyper_layers"]:
        w1 = _dense(w, "hyper_w1_2", F.relu(_dense(w, "hyper_w1_1", s)))
        w2 = _dense(w, "hyper_w2_2", F.relu(_dense(w, "hyper_w2_1", s)))
    else:
        w1, w2 = _dense(w, "hyper_w1", s), _dense(w, "hyper_w2", s)
    w1 = w1.abs().view(-1, N, H)
    w2 = w2.abs().view(-1, H)
    b1 = _dense(w, "hyper_b1", s)
    b2 = _dense(w, "hyper_b2_2", F.relu(_dense(w, "hyper_b2_1", s)))[:, 0]
    h = F.elu((q[:, :, None] * w1).sum(1) + b1)
    return (h * w2).sum(1) + b2


def global_state(cfg: dict, s: dict) -> torch.Tensor:
    """MEDA's global state of a state dict (:mod:`meda`): (B, 2 W L) int8,
    the board of droplet ids, then the board of destination ids, each
    indexed [y][x]; droplet i (id i + 1) paints the cells of its 5x5
    footprint in id order, so a cell holds the largest id covering it."""
    W, L = cfg["width"], cfg["length"]
    ys = torch.arange(W, device=s["center"].device)[:, None]
    xs = torch.arange(L, device=s["center"].device)[None, :]
    boards = []
    for pts in (s["center"], s["dest"]):
        board = torch.zeros((pts.shape[0], W, L), dtype=torch.int8,
                            device=pts.device)
        for i in range(pts.shape[1]):
            x = pts[:, i, 0, None, None]
            y = pts[:, i, 1, None, None]
            covered = ((ys - y).abs() <= meda.RADIUS) & (
                (xs - x).abs() <= meda.RADIUS)
            board = torch.where(covered, i + 1, board).to(torch.int8)
        boards.append(board.flatten(1))
    return torch.cat(boards, 1)


def state_mismatch(cfg: dict, start: dict, uniforms: torch.Tensor,
                   s_ext: torch.Tensor, actions: torch.Tensor) -> int:
    """Elements of a rollout's stored states ``s_ext`` (R, T+1, S) that
    differ from the reference's: its chips stepped from ``start`` with the
    stored ``actions`` (R, T, N) and the move draws ``uniforms`` (T, R, N),
    each step's state stored while the episode runs and zeros after it
    ended."""
    state = dict(start)
    live = torch.ones(s_ext.shape[0], dtype=torch.bool, device=s_ext.device)
    wrong = int((s_ext[:, 0] != global_state(cfg, state)).sum())
    for t in range(actions.shape[1]):
        new, out = meda.step(cfg, state, actions[:, t], uniforms[t])
        expect = torch.where(live[:, None], global_state(cfg, new), 0)
        wrong += int((s_ext[:, t + 1] != expect).sum())
        state = {k: torch.where(live.view(-1, *[1] * (v.dim() - 1)), new[k], v)
                 for k, v in state.items()}
        live = live & ~out["terminated"]
    return wrong


def split(w: dict):
    """A dict of the agent's and the mixer's weights (the mixer's
    prefixed) -> (agent, mixer)."""
    agent = {k: v for k, v in w.items() if not k.startswith(MIXER)}
    mixer = {k[len(MIXER):]: v for k, v in w.items() if k.startswith(MIXER)}
    return agent, mixer


def joined(agent: dict, mixer: dict) -> dict:
    return {**agent, **{MIXER + k: v for k, v in mixer.items()}}


def td_loss(w: dict, target: dict, batch: dict, cfg: dict) -> torch.Tensor:
    """``sum(td^2) / sum(mask)`` of a minibatch (``o_ext`` (b, T+1, N,
    obs), ``u`` (b, T, N, 1), ``r``, ``padded``, ``terminated`` (b, T, 1),
    ``s_ext`` (b, T+1, S)) under the agent's and the mixer's weights ``w``
    and their targets ``target``: the eval mix on the states s_0 .. s_T-1,
    the target mix on s_1 .. s_T."""
    A = cfg["n_actions"]
    agent, mixer = split(w)
    t_agent, t_mixer = split(target)
    o = batch["o_ext"].float()
    u = batch["u"].long()
    r = batch["r"].float()
    term = batch["terminated"].float()
    mask = 1.0 - batch["padded"].float()
    s = batch["s_ext"].float()
    onehot = F.one_hot(u[..., 0], A).float() * mask[..., None]
    eval_in, tgt_in = o[:, :-1], o[:, 1:]
    if cfg["last_action"]:
        prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], 1)
        eval_in = torch.cat([eval_in, prev], dim=-1)
        tgt_in = torch.cat([tgt_in, onehot], dim=-1)
    q_eval = net.unroll(agent, eval_in, cfg)
    with torch.no_grad():
        q_next = net.unroll(t_agent, tgt_in, cfg)
    b, T, N = q_eval.shape[:3]
    q_taken = q_eval.gather(3, u)[..., 0]                      # (b, T, N)
    # every action is available on a live step and none on a padded one
    avail = mask[..., None].expand(q_next.shape)
    q_best = torch.where(avail == 0.0, MASKED_Q, q_next).amax(3)
    rows = lambda x: x.reshape(b * T, x.shape[-1])
    q_tot = mix(mixer, rows(q_taken), rows(s[:, :-1]), cfg).view(b, T, 1)
    with torch.no_grad():
        q_tot_next = mix(t_mixer, rows(q_best), rows(s[:, 1:]),
                         cfg).view(b, T, 1)
    y = r + cfg["gamma"] * q_tot_next * (1.0 - term)
    td = (y.detach() - q_tot) * mask
    return (td ** 2).sum() / mask.sum()


def _update(w: dict, opt: Adam, target: dict, batch: dict, cfg: dict,
            half_batch: bool):
    """One update of ``w`` in place: the loss before it and the clipped
    gradients."""
    if half_batch:
        half = batch["u"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
    loss = td_loss(w, target, batch, cfg)
    grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
    return float(loss.detach()), opt.step(w, grads)


def updates(w0: dict, batches: list, cfg: dict, half_batch: bool = False,
            control: bool = False):
    """Follow ``len(batches)`` updates from the agent's and the mixer's
    weights ``w0`` (:func:`joined`; the targets are ``w0`` throughout: no
    sync falls in so few).  Returns each update's loss before its step,
    the first update's clipped gradients and the weights after the last,
    keyed as ``w0``.  ``half_batch`` computes each loss over the first half
    of its minibatch only (a planted fault); ``control`` computes in
    TF32."""
    float32()
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    target = {k: v.detach().clone() for k, v in w0.items()}
    opt = Adam(w, cfg)
    losses, first = [], None
    with tf32() if control else contextlib.nullcontext():
        for batch in batches:
            loss, clipped = _update(w, opt, target, batch, cfg, half_batch)
            first = clipped if first is None else first
            losses.append(loss)
    return losses, first, {k: v.detach() for k, v in w.items()}


def steps_from(starts: list, batches: list, target: dict, cfg: dict,
               half_batch: bool = False, control: bool = False):
    """Each update taken from a given state: update k from ``starts[k]``,
    the weights and Adam's moments ``(w, mu, nu)`` after k updates (keyed
    as :func:`joined`; zeros before the first), on ``batches[k]``, with the
    targets ``target``.  Returns each update's loss before its step, the
    first update's clipped gradients and each update's weights after its
    step.  ``half_batch`` and ``control`` are :func:`updates`'."""
    float32()
    losses, first, stepped = [], None, []
    with tf32() if control else contextlib.nullcontext():
        for k, (batch, (w0, mu, nu)) in enumerate(zip(batches, starts)):
            w = {n: v.detach().clone().requires_grad_(True)
                 for n, v in w0.items()}
            opt = Adam(w, cfg)
            opt.mu = {n: v.detach().clone() for n, v in mu.items()}
            opt.nu = {n: v.detach().clone() for n, v in nu.items()}
            opt.count = k
            loss, clipped = _update(w, opt, target, batch, cfg, half_batch)
            first = clipped if first is None else first
            losses.append(loss)
            stepped.append({n: v.detach() for n, v in w.items()})
    return losses, first, stepped


@torch.no_grad()
def losses_at(weights: list, batches: list, target: dict,
              cfg: dict) -> list:
    """The loss of each ``batches[k]`` under ``weights[k]`` and the targets
    ``target``, in float32: where an update's step left the loss of its
    own minibatch."""
    float32()
    return [float(td_loss(w, target, batch, cfg))
            for w, batch in zip(weights, batches)]
