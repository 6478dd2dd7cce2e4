"""The VDN and QMIX learner (JAX ``algos/qlearn.py``, ``make_learner``).

One update samples a minibatch of episodes, unrolls the agent net over the
episode's T steps for the eval stream (with gradients) and the target
stream (without), takes the chosen and the masked-max target Qs, mixes them
over the agents — a sum for VDN, the state-conditioned mixer for QMIX, on
the episode's global states ``s_ext`` — and minimises the masked TD loss
with a global-norm clip and Adam (or RMSprop, or SGD).  The clip, the
optimizer, the EMA and the target sync act on the agent's and the mixer's
parameters alike, as optax does on the JAX package's whole params tree; the
target nets are copied from the eval nets every ``target_update_cycle``
updates.  An unroll (:func:`unroll`) runs the encoder and the Q head once
over every (step, episode, agent) row and the GRU over the whole sequence
in one call, cuDNN's on a card; ``--remat``, ``--fused_streams``, bf16 and
the seed farm loop over time instead, one call of the whole net a step.
``--remat`` recomputes each time step's activations in the backward pass,
as JAX's ``jax.checkpoint`` around the scan body (:func:`checkpoint`); the
loss and the gradients are the same.
``--fused_streams`` runs the eval and the target streams in one unroll over
the two nets' parameters stacked (JAX ``unroll_pair``), the target half
detached.

Under a mesh of n ranks (``parallel/mesh.py``) the loss is the global
minibatch's, ``sum(td^2) / sum(mask)`` over every rank's episodes (JAX
``qlearn.py:273``): a rank differentiates its own ``sum(td^2)``, and the
gradients, the squared sums and the mask counts go through one
``all_reduce`` before the division, so that the clip and the optimizer see
the same gradients on every rank and the parameters stay replicated.  The
minibatch is the global ring's (``replay.sample``) or, with
``--local_sampling``, each rank's own share (``replay.sample_local``).

The JAX package had no Pallas kernel here; the port runs cuDNN/cuBLAS
through ``torch.nn`` and writes the optimizer step by hand, in optax's
form, because torch's own optimizers differ from optax's:

* the clip is optax's ``clip_by_global_norm``: ``g * max_norm / |g|`` only
  when ``|g| >= max_norm`` (torch's ``clip_grad_norm_`` adds 1e-6 to the
  norm and always multiplies);
* ``RMS`` is optax's ``rmsprop``: decay 0.9, eps inside the square root,
  no bias correction (torch's ``RMSprop`` puts eps outside);
* ``--lr_decay`` is optax's ``cosine_decay_schedule(lr, total_updates,
  alpha=0.05)``, read at the update count before the step and flat after
  ``total_updates`` (torch's ``CosineAnnealingLR`` rises again after
  ``T_max``).

The optimizer's counts are int32 tensors on the CPU, so the bias
corrections and the schedule are computed on the host in float32 and no
update waits for the device.

The loss is a module, :class:`TDLoss`, over the eval and target nets;
:func:`functional_loss` calls it on any parameter dicts, which is how the
seed farm's :class:`StackedQLearner` takes the loss and gradients of S
seeds' stacked parameters at once (``torch.func.vjp`` of its
``torch.func.vmap``; JAX ``seedfarm.py`` vmaps ``learn``).

An update's spans (``utils/tracing.py``), inside ``learn_many``'s:
``learn.sample`` (the minibatch's gather), ``learn.forward`` (both
unrolls and the TD loss), ``learn.backward`` (the gradients, and under a
mesh their ``all_reduce``) and ``learn.optim`` (the clip, the optimizer
step, the target sync); under QMIX ``learn.mix`` (the eval and the target
mixer calls) inside ``learn.forward``.  The counter ``learn.rows`` adds
each minibatch's (episode, step, agent) rows, ``learn.unroll.sequence``
and ``learn.unroll.stepwise`` the streams unrolled by each path, and
``learn.mix.rows`` the (episode, step) rows each mixer call mixes, 2 b T
an update.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from marl_dmfb_tpu_torch.models.networks import (StackedNet,
                                                 runs_as_sequence, stackable,
                                                 vdn_mix)
from marl_dmfb_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                               replicate)
from marl_dmfb_tpu_torch.replay import (ReplayState, sample, sample_local,
                                        sample_stacked)
from marl_dmfb_tpu_torch.utils import tracing
from marl_dmfb_tpu_torch.utils.platform import disable_tf32

ADAM_BETAS = (0.9, 0.99)   # JAX qlearn.py:78 (reference vdn.py:67-68)
EPS = 1e-8                 # optax's default for adam and rmsprop
RMS_DECAY = 0.9            # optax's rmsprop default
LR_DECAY_ALPHA = 0.05      # cosine decay to 5% of lr (JAX qlearn.py:69-71)
MASKED_Q = -9999999.0      # target Q of an unavailable action (vdn.py:109)


def _f32(x) -> np.float32:
    return np.float32(x)


def _count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_norm), adam | rmsprop | sgd)``
    over a dict of named tensors, stepping the parameters in place.

    The state is a dict of tensors laid out as optax's: Adam holds
    ``count``, ``mu`` and ``nu``; RMS holds ``nu``; SGD nothing; a decaying
    learning rate adds ``schedule_count``."""

    def __init__(self, kind: str, lr: float, max_norm: float,
                 decay_steps: Optional[int] = None):
        self.kind = kind
        self.lr = lr
        self.max_norm = max_norm
        self.decay_steps = decay_steps

    def init(self, params: dict) -> dict:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        state = {}
        if self.kind == "ADAM":
            state = {"count": _count(), "mu": zeros(), "nu": zeros()}
        elif self.kind == "RMS":
            state = {"nu": zeros()}
        if self.decay_steps is not None:
            state["schedule_count"] = _count()
        return state

    def learning_rate(self, count: int) -> np.float32:
        """The step size at ``count`` updates (optax's
        ``cosine_decay_schedule``, in float32)."""
        if self.decay_steps is None:
            return _f32(self.lr)
        c = _f32(min(count, self.decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(
            _f32(math.pi) * c / _f32(self.decay_steps)))
        decayed = _f32(1 - LR_DECAY_ALPHA) * cosine + _f32(LR_DECAY_ALPHA)
        return _f32(self.lr) * decayed

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict,
             stacked: bool = False) -> dict:
        """Clip ``grads`` by their global norm, take one step of the
        parameters in place and return the new state.

        ``stacked`` tensors carry S independent seeds on their first axis
        (the seed farm): each seed's gradients are clipped by their own
        global norm, over every axis but the first, and the rest of the
        step is elementwise; the counts are shared, as the seeds update in
        lockstep."""
        if stacked:
            def norm_of(g):   # (S,): each seed's squared norm
                return torch.sum(g * g, dim=tuple(range(1, g.dim())))
            g_norm = torch.sqrt(sum(norm_of(g) for g in grads.values()))
            per_seed = lambda x, g: x.view(-1, *[1] * (g.dim() - 1))
        else:
            g_norm = torch.sqrt(sum(torch.sum(g * g)
                                    for g in grads.values()))
            per_seed = lambda x, g: x
        keep = g_norm < self.max_norm
        grads = {k: torch.where(per_seed(keep, g), g,
                                g / per_seed(g_norm, g) * self.max_norm)
                 for k, g in grads.items()}
        state = dict(state)
        if "schedule_count" in state:
            n = int(state["schedule_count"])
            lr = self.learning_rate(n)
            state["schedule_count"] = torch.tensor(n + 1, dtype=torch.int32)
        else:
            lr = self.learning_rate(0)
        scale = float(-lr)
        if self.kind == "ADAM":
            b1, b2 = ADAM_BETAS
            count = int(state["count"]) + 1
            bc1 = float(_f32(1) - _f32(b1) ** _f32(count))
            bc2 = float(_f32(1) - _f32(b2) ** _f32(count))
            mu, nu = {}, {}
            for k, g in grads.items():
                mu[k] = (1 - b1) * g + b1 * state["mu"][k]
                nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
                u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
                params[k].add_(u * scale)
            state.update(count=torch.tensor(count, dtype=torch.int32),
                         mu=mu, nu=nu)
        elif self.kind == "RMS":
            nu = {}
            for k, g in grads.items():
                nu[k] = (1 - RMS_DECAY) * (g * g) + RMS_DECAY * state["nu"][k]
                params[k].add_(torch.rsqrt(nu[k] + EPS) * g * scale)
            state["nu"] = nu
        else:
            for k, g in grads.items():
                params[k].add_(g * scale)
        return state


def make_optimizer(args) -> Optimizer:
    """The optimizer per config (JAX qlearn.py:50-79): ``RMS``, ``SGD``, or
    Adam for anything else (the reference maps ``ASGD`` to Adam too).

    With ``--lr_decay`` the schedule runs over the JAX package's estimate
    of the run's updates: failures count the full episode limit, so an
    episode counts about 0.75 T env steps."""
    decay_steps = None
    if args.lr_decay:
        est_steps_per_ep = max(1, int(0.75 * args.episode_limit))
        decay_steps = max(1, int(args.total_env_steps * args.train_time
                                 / (args.n_episodes * est_steps_per_ep)))
    kind = args.optimizer if args.optimizer in ("RMS", "SGD") else "ADAM"
    return Optimizer(kind, args.lr, args.grad_norm_clip, decay_steps)


class _Remat(torch.autograd.Function):
    """``fn(*args)`` whose backward runs ``fn`` again (``torch.func.vjp``)
    instead of keeping its activations.  Written with ``setup_context`` and
    a generated vmap rule, so that ``torch.func.grad`` and ``vmap`` take
    it (the seed farm's learner), which ``torch.utils.checkpoint`` is
    not."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        _, vjp = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
        return (None, *vjp(grads))


def checkpoint(net, x: torch.Tensor, h: torch.Tensor):
    """``net(x, h)`` (a module, or a :class:`StackedNet`), its activations
    recomputed in the backward pass; the parameters are inputs of the
    recomputation, so their gradients flow as without it."""
    if isinstance(net, StackedNet):
        params, apply = net.params, net.apply
    else:
        params = dict(net.named_parameters())

        def apply(p, x, h):
            return torch.func.functional_call(net, p, (x, h))
    names = list(params)

    def step(*args):
        return apply(dict(zip(names, args[:-2])), *args[-2:])

    return _Remat.apply(step, *params.values(), x, h)


def sequence_unroll(net, x_tb: torch.Tensor) -> torch.Tensor:
    """The net over a whole sequence ``x_tb`` ``(T, R, in_dim)`` -> Qs
    ``(T, R, n_actions)``: the encoder and the Q head, which read no
    hidden state, once over all T*R rows, and the GRU in one sequence call
    (:meth:`TorchGRUCell.sequence`)."""
    T, R = x_tb.shape[:2]
    x = net.encode(x_tb.reshape(T * R, -1)).view(T, R, -1)
    h = net.gru.sequence(x)
    return net.head(h.reshape(T * R, -1)).view(T, R, -1)


def unroll(net, inputs: torch.Tensor, rnn_hidden: int,
           remat: bool = False) -> torch.Tensor:
    """The net (a module, or a :class:`StackedNet`) over time on ``(b*N)``
    rows: inputs ``(b, T, N, in_dim)`` -> Qs ``(b, T, N, n_actions)``.

    A float32 agent module (:func:`runs_as_sequence`) without ``remat``
    takes :func:`sequence_unroll`.  Else the whole net runs in a loop over
    time: under ``remat``, whose point is to keep no step's activations,
    each step's are recomputed in the backward pass (with gradients); a
    :class:`StackedNet`, the seed farm's stacked cells and bf16 cannot take
    the sequence call.  The counters ``learn.unroll.sequence`` and
    ``learn.unroll.stepwise`` count the streams each path unrolls (a
    :class:`StackedNet`'s parameter sets, each one)."""
    b, T, N = inputs.shape[:3]
    x_tb = inputs.transpose(0, 1).reshape(T, b * N, -1)
    if not remat and runs_as_sequence(net):
        tracing.count("learn.unroll.sequence", 1)
        return sequence_unroll(net, x_tb).view(T, b, N, -1).transpose(0, 1)
    tracing.count("learn.unroll.stepwise",
                  net.n_seeds if isinstance(net, StackedNet) else 1)
    h = inputs.new_zeros((b * N, rnn_hidden))
    remat = remat and torch.is_grad_enabled()
    qs = []
    for t in range(T):
        if remat:
            q, h = checkpoint(net, x_tb[t], h)
        else:
            q, h = net(x_tb[t], h)
        qs.append(q)
    return torch.stack(qs).view(T, b, N, -1).transpose(0, 1)


MIXER = "mixer."   # the prefix of the mixer's names in a flat dict


def _nest(flat: dict) -> dict:
    """A flat dict of :attr:`QLearner.all_params`' names -> ``{"agent":
    {name: tensor}, "mixer": {name: tensor}}``."""
    out: dict = {}
    for name, v in flat.items():
        part = "mixer" if name.startswith(MIXER) else "agent"
        out.setdefault(part, {})[name.removeprefix(MIXER)] = v
    return out


def _flat(tree: dict) -> dict:
    return {(MIXER if part == "mixer" else "") + name: v
            for part, d in tree.items() for name, v in d.items()}


def _rows(batch: dict) -> int:
    """The minibatch's rows, (episode, step, agent) triples of ``o_ext``
    (a seed axis first multiplies them)."""
    return math.prod(batch["o_ext"].shape[:-1])


def _one_hot(u: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(u, n).float()`` by comparison: ``F.one_hot`` reads the
    values' range, which ``torch.func.vmap`` cannot batch."""
    return (u[..., None] == torch.arange(n, device=u.device)).float()


class TDLoss(nn.Module):
    """The masked TD loss of a minibatch (JAX qlearn.py:234-273) over the
    eval nets (the agent, and under QMIX the mixer) and their target
    copies, which are its submodules ``net``, ``mixer``, ``target_net`` and
    ``target_mixer``.  :func:`functional_loss` calls it on other
    parameters."""

    def __init__(self, args, net: nn.Module, mixer: Optional[nn.Module],
                 target_net: nn.Module, target_mixer: Optional[nn.Module]):
        super().__init__()
        self.args = args
        self.net, self.mixer = net, mixer
        self.target_net, self.target_mixer = target_net, target_mixer
        # --fused_streams: the agent called on the 2-stack of the eval and
        # target parameters (a copy gives the calls their structure; a
        # StackedNet is no module, so the copy's own parameters are not
        # the loss's)
        self._pair = (StackedNet(copy.deepcopy(net), {}, 2)
                      if args.fused_streams else None)

    def build_inputs(self, batch: dict, u_onehot: torch.Tensor):
        """Eval stream: ``o_ext[:, :T]`` with the previous step's action
        one-hot (zeros at t = 0); target stream: ``o_ext[:, 1:]`` with this
        step's (JAX qlearn.py:216-232)."""
        o_ext = batch["o_ext"].float()
        eval_obs, tgt_obs = o_ext[:, :-1], o_ext[:, 1:]
        if not self.args.last_action:
            return eval_obs, tgt_obs
        prev_u = torch.cat(
            [torch.zeros_like(u_onehot[:, :1]), u_onehot[:, :-1]], dim=1)
        return (torch.cat([eval_obs, prev_u], dim=-1),
                torch.cat([tgt_obs, u_onehot], dim=-1))

    def unroll_pair(self, eval_in: torch.Tensor, tgt_in: torch.Tensor):
        """Both streams in one unroll (JAX ``unroll_pair``): each step
        calls the agent once on the eval rows under the eval parameters and
        the target rows under the target ones (detached).  Returns
        ``(q_evals, q_targets)``, those of two separate unrolls to float32
        rounding."""
        target = dict(self.target_net.named_parameters())
        self._pair.params = {
            k: torch.stack([p, target[k].detach()])
            for k, p in self.net.named_parameters()}
        q = unroll(self._pair, torch.cat([eval_in, tgt_in]),
                   self.args.rnn_hidden_dim, bool(self.args.remat))
        b = eval_in.shape[0]
        return q[:b], q[b:].detach()

    def forward(self, batch: dict) -> torch.Tensor:
        """The loss of a minibatch in the ``(b, T, N, .)`` views."""
        squares, mask_sum = self.td_sums(batch)
        return squares / mask_sum

    def td_sums(self, batch: dict):
        """``(sum(td^2), sum(mask))`` of a minibatch, whose quotient is the
        loss."""
        H, A = self.args.rnn_hidden_dim, self.args.n_actions
        remat = bool(self.args.remat)
        u = batch["u"].long()                          # (b, T, N, 1)
        r = batch["r"].float()                         # (b, T, 1)
        terminated = batch["terminated"].float()
        mask = 1.0 - batch["padded"].float()           # (b, T, 1)
        # the one-hots are zero on padded steps, and every action is
        # available on a live step and none on a padded one
        u_onehot = _one_hot(u[..., 0], A) * mask[..., None]
        avail_next = mask[..., None].expand(u_onehot.shape)
        eval_in, tgt_in = self.build_inputs(batch, u_onehot)
        if self._pair is not None:
            q_evals, q_targets = self.unroll_pair(eval_in, tgt_in)
        else:
            q_evals = unroll(self.net, eval_in, H, remat)
            with torch.no_grad():
                q_targets = unroll(self.target_net, tgt_in, H, remat)
        q_e = q_evals.gather(3, u).squeeze(3)          # (b, T, N)
        q_t = torch.where(avail_next == 0.0, MASKED_Q, q_targets).amax(3)
        if self.mixer is None:
            q_tot_e, q_tot_t = vdn_mix(q_e), vdn_mix(q_t)
        else:
            s_ext = batch["s_ext"].float()
            rows = q_e.shape[0] * q_e.shape[1]
            with tracing.span("learn.mix"):
                q_tot_e = self.mixer(q_e, s_ext[:, :-1])
                tracing.count("learn.mix.rows", rows)
                with torch.no_grad():
                    q_tot_t = self.target_mixer(q_t, s_ext[:, 1:])
                tracing.count("learn.mix.rows", rows)
        targets = r + self.args.gamma * q_tot_t * (1.0 - terminated)
        td = (targets.detach() - q_tot_e) * mask
        return torch.sum(td ** 2), torch.sum(mask)


def functional_loss(loss: TDLoss):
    """``loss`` as a function ``(params, target_params, batch) -> loss`` of
    parameter dicts in :attr:`QLearner.all_params`' names (the agent's
    names, the mixer's prefixed ``mixer.``), through
    ``torch.func.functional_call``: the form ``torch.func.grad`` and
    ``vmap`` take."""
    def call(params: dict, target_params: dict, batch: dict):
        named = {}
        for prefix, tree in (("", params), ("target_", target_params)):
            for k, v in tree.items():
                named[prefix + (k if k.startswith(MIXER) else "net." + k)] = v
        return torch.func.functional_call(loss, named, (batch,))

    return call


class QLearner:
    """The eval nets (the agent, trained in place, which the rollout may
    share, and under QMIX the mixer), their target copies, the optimizer
    state and the update count (JAX ``make_learner``).

    :meth:`state` and :meth:`load_state` carry them as the tree that the
    JAX package's ``LearnerState`` is: ``params`` and ``target_params``
    (``{"agent": {name: tensor}, "mixer": {...}}``, the mixer only under
    QMIX), ``opt_state`` (its moments in the same layout) and
    ``train_step``.

    Under ``mesh`` the nets take rank 0's parameters, and every update
    keeps them alike on every rank (module docstring)."""

    def __init__(self, args, net: nn.Module,
                 mixer: Optional[nn.Module] = None,
                 mesh: Optional[Mesh] = None):
        if args.alg not in ("vdn", "qmix"):
            raise ValueError(f"unknown --alg {args.alg!r}: vdn or qmix")
        if (args.alg == "qmix") != (mixer is not None):
            raise ValueError("--alg qmix takes a mixer, and vdn none")
        if (mesh is not None and args.local_sampling
                and args.batch_size % mesh.size):
            raise ValueError(
                f"--local_sampling: batch_size ({args.batch_size}) must tile "
                f"the {mesh.size}-device mesh")
        disable_tf32()
        self.args = args
        self.mesh = mesh
        self.net = replicate(mesh, net)
        self.mixer = replicate(mesh, mixer)
        self.target_net = copy.deepcopy(net).requires_grad_(False)
        self.target_mixer = (None if mixer is None else
                             copy.deepcopy(mixer).requires_grad_(False))
        self.params = dict(net.named_parameters())   # the agent's
        # the agent's and the mixer's, the mixer's names prefixed
        self.all_params = dict(self.params)
        if mixer is not None:
            self.all_params.update(
                {MIXER + k: v for k, v in mixer.named_parameters()})
        self.loss_module = TDLoss(args, net, mixer, self.target_net,
                                  self.target_mixer)
        self.opt = make_optimizer(args)
        self.opt_state = self.opt.init(self.all_params)
        self.train_step = 0

    def _pairs(self):
        """(eval, target) module pairs: the agent, then the mixer."""
        yield self.net, self.target_net
        if self.mixer is not None:
            yield self.mixer, self.target_mixer

    def loss(self, batch: dict) -> torch.Tensor:
        """The masked TD loss of a minibatch in the ``(b, T, N, .)`` views
        (JAX qlearn.py:234-273)."""
        return self.loss_module(batch)

    def loss_and_grads(self, batch: dict):
        """The loss and its gradients, keyed as :attr:`all_params` (the
        agent's names, and the mixer's with the prefix ``mixer.``); under a
        mesh, those of the global minibatch, of which ``batch`` is this
        rank's share."""
        params = list(self.all_params.values())
        if self.mesh is None:
            with tracing.span("learn.forward"):
                loss = self.loss(batch)
            with tracing.span("learn.backward"):
                return loss, dict(zip(self.all_params,
                                      torch.autograd.grad(loss, params)))
        with tracing.span("learn.forward"):
            squares, mask_sum = self.loss_module.td_sums(batch)
        with tracing.span("learn.backward"):
            grads = torch.autograd.grad(squares, params)
            flat = all_reduce_sum(self.mesh, torch.cat(
                [g.reshape(-1) for g in grads]
                + [squares.detach().reshape(1), mask_sum.reshape(1)]))
            total = flat[-1]
            out, at = {}, 0
            for k, g in zip(self.all_params, grads):
                out[k] = flat[at:at + g.numel()].view_as(g) / total
                at += g.numel()
            return flat[-2] / total, out

    def update(self, batch: dict) -> torch.Tensor:
        """One step on ``batch``; the target nets take the eval nets'
        parameters when the new update count is a multiple of
        ``target_update_cycle`` (JAX qlearn.py:275-294).  Returns the loss
        before the step."""
        loss, grads = self.loss_and_grads(batch)
        with tracing.span("learn.optim"):
            self.opt_state = self.opt.step(self.all_params, grads,
                                           self.opt_state)
            self.train_step += 1
            if self.train_step % self.args.target_update_cycle == 0:
                with torch.no_grad():
                    for live, target in self._pairs():
                        for t, p in zip(target.parameters(),
                                        live.parameters()):
                            t.copy_(p)
        return loss.detach()

    def learn_many(self, replay: ReplayState, n_updates: int,
                   generator: Optional[torch.Generator] = None,
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``n_updates`` sample-and-update steps; returns the mean loss.
        ``idx`` ``(n_updates, batch_size)`` gives the minibatches' episode
        indices instead of drawing them from ``generator``.

        Under a mesh ``replay`` is this rank's part of the ring, and
        ``generator`` is alike on every rank.  With ``--local_sampling``
        each rank draws ``batch_size / n`` indices of its own ring from a
        stream of its own, seeded with a number drawn from ``generator``
        plus its rank (JAX folds the device index into the key), and
        ``idx`` ``(n_updates, batch_size / n)`` holds this rank's; else
        ``idx`` holds the whole minibatch's, as on one device."""
        with tracing.span("learn_many"):
            local = self.mesh is not None and self.args.local_sampling
            b = self.args.batch_size
            if local and idx is None:
                device = replay.data["u"].device
                seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                                         device=device))
                generator = torch.Generator(device=device).manual_seed(
                    seed + self.mesh.rank)
            losses = []
            for k in range(n_updates):
                i = None if idx is None else idx[k]
                with tracing.span("learn.sample"):
                    batch = (sample_local(replay, b, self.mesh, generator, i)
                             if local else
                             sample(replay, b, generator, i, self.mesh))
                tracing.count("learn.rows", _rows(batch))
                losses.append(self.update(batch))
            return torch.stack(losses).mean()

    # ------------------------------------------------------------------
    def _named(self, target: bool = False) -> dict:
        """``{"agent": params, "mixer": params}`` of the eval or the target
        nets (the mixer only under QMIX)."""
        return {part: dict(nets[target].named_parameters())
                for part, nets in zip(("agent", "mixer"), self._pairs())}

    def state(self) -> dict:
        """The learner's state as a tree of tensors (copies)."""
        copy_of = lambda tree: {part: {k: v.detach().clone()
                                       for k, v in d.items()}
                                for part, d in tree.items()}
        opt = {k: (copy_of(_nest(v)) if isinstance(v, dict) else v.clone())
               for k, v in self.opt_state.items()}
        return {
            "params": copy_of(self._named()),
            "target_params": copy_of(self._named(target=True)),
            "opt_state": opt,
            "train_step": torch.tensor(self.train_step, dtype=torch.int32),
        }

    @torch.no_grad()
    def load_state(self, tree: dict):
        """Take a tree laid out as :meth:`state`'s (checked by name first,
        e.g. by ``checkpoint.restructure``)."""
        for target, key in ((False, "params"), (True, "target_params")):
            for part, params in self._named(target).items():
                for k, p in params.items():
                    p.copy_(tree[key][part][k])
        device = next(iter(self.params.values())).device
        self.opt_state = {
            k: ({n: t.to(device).clone() for n, t in _flat(v).items()}
                if isinstance(v, dict) else v.cpu().to(torch.int32))
            for k, v in tree["opt_state"].items()}
        self.train_step = int(tree["train_step"])


class StackedQLearner:
    """S independent learners of one configuration, updated in lockstep as
    one program (the seed farm's; JAX ``seedfarm.py`` vmaps ``learn``).

    ``params`` holds every seed's parameters stacked on a first axis of S,
    in :attr:`QLearner.all_params`' flat names.  An update takes the loss
    and gradients of all seeds at once, ``torch.func.vjp`` of the
    ``torch.func.vmap`` of :func:`functional_loss` over the stacked
    parameters and S minibatches, so it launches about as many
    kernels as one seed's update; the optimizer clips each seed by its own
    global norm (``Optimizer.step(stacked=True)``).  The template modules
    ``net`` and ``mixer`` give the loss its structure only (their GRU cells
    in the stacked form, :func:`stackable`); their own parameters are not
    used.  Seed i's state is what a :class:`QLearner` of seed i's weights
    would hold after the same minibatches, to float32 rounding (the
    batched products and convolutions sum in another order)."""

    def __init__(self, args, net: nn.Module, mixer: Optional[nn.Module],
                 params: dict):
        if args.alg not in ("vdn", "qmix"):
            raise ValueError(f"unknown --alg {args.alg!r}: vdn or qmix")
        disable_tf32()
        self.args = args
        stackable(net)
        self.loss_module = TDLoss(
            args, net, mixer, stackable(copy.deepcopy(net)),
            None if mixer is None else copy.deepcopy(mixer))
        self.params = params
        self.target_params = {k: v.clone() for k, v in params.items()}
        self.n_seeds = next(iter(params.values())).shape[0]
        self.opt = make_optimizer(args)
        self.opt_state = self.opt.init(params)
        self.train_step = 0
        self._losses = torch.func.vmap(functional_loss(self.loss_module))

    def agent_params(self, tree: Optional[dict] = None) -> dict:
        """The agent's entries of ``tree`` (default :attr:`params`)."""
        tree = self.params if tree is None else tree
        return {k: v for k, v in tree.items() if not k.startswith(MIXER)}

    def loss_and_grads(self, batch: dict):
        """Each seed's loss (S,) and gradients on its minibatch (each leaf
        of ``batch`` is (S, b, ...)): the vector-Jacobian product of the
        seeds' losses with ones, as the seeds' losses depend each on its
        own parameters alone."""
        with tracing.span("learn.forward"):
            loss, backward = torch.func.vjp(
                lambda p: self._losses(p, self.target_params, batch),
                self.params)
        with tracing.span("learn.backward"):
            (grads,) = backward(torch.ones_like(loss))
        return loss, grads

    def update(self, batch: dict) -> torch.Tensor:
        """One lockstep step of every seed on its minibatch, the target
        sync as :meth:`QLearner.update`'s; returns the losses (S,) before
        the step."""
        loss, grads = self.loss_and_grads(batch)
        with tracing.span("learn.optim"):
            self.opt_state = self.opt.step(self.params, grads,
                                           self.opt_state, stacked=True)
            self.train_step += 1
            if self.train_step % self.args.target_update_cycle == 0:
                with torch.no_grad():
                    for k, v in self.params.items():
                        self.target_params[k].copy_(v)
        return loss.detach()

    def learn_many(self, replay: ReplayState, n_updates: int,
                   generators, idx: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """``n_updates`` sample-and-update steps of every seed on its ring
        of ``replay`` (a seed axis first, ``replay.init_replay(seeds=S)``):
        seed i draws its minibatch from ``generators[i]`` as a
        :class:`QLearner` does from its generator, or takes ``idx[k, i]``.
        Returns each seed's mean loss (S,)."""
        with tracing.span("learn_many"):
            losses = []
            n = self.args.batch_size
            for k in range(n_updates):
                with tracing.span("learn.sample"):
                    if idx is None:
                        device = replay.data["u"].device
                        ks = torch.stack([
                            torch.randint(0, max(replay.size, 1), (n,),
                                          generator=g, device=device)
                            for g in generators])
                    else:
                        ks = idx[k]
                    batch = sample_stacked(replay, ks)
                tracing.count("learn.rows", _rows(batch))
                losses.append(self.update(batch))
            return torch.stack(losses).mean(dim=0)

    # ------------------------------------------------------------------
    def state(self) -> dict:
        """The stacked state in :meth:`QLearner.state`'s layout, each leaf
        with the seed axis first but the optimizer's counts (copies)."""
        nest = lambda flat: {part: {k: v.detach().clone()
                                    for k, v in d.items()}
                             for part, d in _nest(flat).items()}
        return {
            "params": nest(self.params),
            "target_params": nest(self.target_params),
            "opt_state": {k: (nest(v) if isinstance(v, dict) else v.clone())
                          for k, v in self.opt_state.items()},
            "train_step": torch.tensor(self.train_step, dtype=torch.int32),
        }

    def seed_state(self, i: int) -> dict:
        """Seed ``i``'s state, laid out as :meth:`QLearner.state`'s (the
        counts, 0-dim, are every seed's)."""
        def pick(tree):
            if isinstance(tree, dict):
                return {k: pick(v) for k, v in tree.items()}
            return tree[i].clone() if tree.dim() else tree
        return pick(self.state())

    @torch.no_grad()
    def load_state(self, tree: dict):
        """Take a tree laid out as :meth:`state`'s (checked by name first)."""
        for key, dst in (("params", self.params),
                         ("target_params", self.target_params)):
            for k, v in _flat(tree[key]).items():
                dst[k].copy_(v)
        device = next(iter(self.params.values())).device
        self.opt_state = {
            k: ({n: t.to(device).clone() for n, t in _flat(v).items()}
                if isinstance(v, dict) else v.cpu().to(torch.int32))
            for k, v in tree["opt_state"].items()}
        self.train_step = int(tree["train_step"])
