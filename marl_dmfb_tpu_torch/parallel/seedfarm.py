"""The seed farm (``--vmap_seeds S``): S independent trainings of one
configuration as one program (JAX ``parallel/seedfarm.py``).

The reference answers "is this recipe seed-stable?" by training again with
each seed.  Here the S seeds advance in lockstep: their parameters,
optimizer moments, replay rings and epsilons carry a seed axis first, their
chips are one flat batch of S*B, and each collect-and-learn cycle runs
every seed at about one seed's count of kernel launches:

* the env step takes all S*B chips at once; on CUDA a DMFB farm rollout
  launches the ``dmfb_step`` kernel T times (``ops/dmfb_step.py``), a MEDA
  one runs its plain step on the same flat batch;
* the nets run over stacked parameters, ``torch.func.vmap`` of
  ``functional_call`` (``models/networks.py:StackedNet``), and so does the
  learner's loss and gradient (``algos/qlearn.py:StackedQLearner``); the
  optimizer clips each seed by its own global norm.

Randomness.  Seed i draws exactly what ``Trainer(seed + i)`` draws
(``trainer.py``): its weights from a CPU generator seeded ``seed + i``
(the agent's, then a QMIX mixer's), and from one generator on the device
seeded ``seed + i`` the evaluation chips, the training chips, then in each
cycle the rollout's draws (the reset's new tasks, then per step a random
action, an exploration draw and a move-success draw, each (B, N)) and each
update's minibatch indices.  Draws from a generator depend only on the
order and the shapes of the calls on it, so the farm makes each seed's
rollout draws ahead, in the rollout's order, and passes them through the
rollout's ``noise=``.  Each seed anneals its own epsilon by its own share
of live episodes.  A seed's numbers are a Trainer's to float32 rounding:
the batched products and grouped convolutions sum in another order.

Two differences from S separate runs, both on the evaluation side, are the
JAX farm's:

* the evaluation cadence follows the mean env-step count over the seeds;
* evaluation draws (the tasks and the move-success draws of the greedy
  rollouts) come from a generator of each seed's own, seeded
  ``EVAL_SEED_OFFSET + seed + i``; a Trainer draws them from its one
  stream, between its training draws.

Artifacts of seed i: checkpoints ``model/<alg>/fov<f>/{i}_<tag>_state.pt``
in the Trainer's layout without a replay ring, which
``Trainer.load_model`` and ``evaluate --ith_run=i`` read, and the curves
under the Trainer's file names, beside ``..._farm.npy`` holding all seeds'
(S, E).

Resume: each evaluation cycle writes ``farm_<E>_resume.pt``: the stacked
learner state, the EMA, the epsilons, every seed's two generators, the
training and evaluation chips and the curves so far; under
``--ckpt_replay`` also the rings.  The two newest are kept, so that a run
killed while writing one leaves the other.  ``--load_model`` restores the
newest readable one and continues; under ``--ckpt_replay`` the
continuation is bitwise that of an uninterrupted run, and without it the
rings restart empty, as the Trainer's resume does.  A checkpoint written
with another ``--param_ema`` or ``--ckpt_replay`` raises ``ValueError``.
``--remat`` recomputes each BPTT step under ``torch.func`` too
(``algos/qlearn.py:checkpoint``).
"""

from __future__ import annotations

import os
import pickle
import re
import time
from typing import Optional

import numpy as np
import torch

from marl_dmfb_tpu_torch import checkpoint
from marl_dmfb_tpu_torch.algos.qlearn import (MIXER, StackedQLearner, _flat,
                                              _nest)
from marl_dmfb_tpu_torch.config import Args
from marl_dmfb_tpu_torch.envs.registry import Env
from marl_dmfb_tpu_torch.models.networks import (StackedNet, build_agent_net,
                                                 build_mixer, init_params)
from marl_dmfb_tpu_torch.replay import (ReplayState, init_replay,
                                        store_stacked)
from marl_dmfb_tpu_torch.rollout import RolloutNoise, make_rollout
from marl_dmfb_tpu_torch.trainer import (NET_CONFIG, curve_dir, curve_prefix,
                                         updates_per_rollout)
from marl_dmfb_tpu_torch.utils import tracing
from marl_dmfb_tpu_torch.utils.platform import disable_tf32

EVAL_SEED_OFFSET = 1 << 31   # seed i's evaluation stream: offset + seed + i
CURVES = ("success_rate", "Rewards", "steps", "constraints")
_RESUME = re.compile(r"farm_(\d+)_resume\.pt")


def resume_tags(model_dir: str) -> list:
    """The evaluation cycles of the farm's resume checkpoints in
    ``model_dir``, ascending."""
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_RESUME.fullmatch,
                                               os.listdir(model_dir)) if m)


def _cat(states: list):
    """One batched env state of the seeds' states, seed-major."""
    return type(states[0])(*(torch.cat(f) for f in zip(*states)))


def _split(states, n: int) -> list:
    """``n`` equal seed-major slices (views) of a batched env state."""
    b = states[0].shape[0] // n
    return [type(states)(*(f[i * b:(i + 1) * b] for f in states))
            for i in range(n)]


class SeedFarm:
    """S seeds of ``args`` trained in lockstep (module docstring)."""

    def __init__(self, env: Env, args: Args, n_seeds: int):
        if n_seeds < 1:
            raise ValueError(f"a farm needs at least one seed, got {n_seeds}")
        disable_tf32()
        self.env, self.args, self.S = env, args, n_seeds
        self.device = device = torch.device(args.device)
        args.update_env_info(env.env_info())
        S, self.B = n_seeds, args.rollout_batch

        # seed i's weights: Trainer(seed + i)'s
        weights = []
        for i in range(S):
            g = torch.Generator().manual_seed(args.seed + i)
            seed_params = dict(init_params(build_agent_net(args),
                                           g).named_parameters())
            mixer = build_mixer(args)
            if mixer is not None:
                seed_params.update({MIXER + k: v for k, v in
                                    init_params(mixer, g).named_parameters()})
            weights.append(seed_params)
        params = {k: torch.stack([w[k].detach() for w in weights]).to(device)
                  for k in weights[0]}
        # templates: the structure of the stacked calls, not their weights
        self.net = build_agent_net(args).to(device)
        self.mixer = build_mixer(args)
        if self.mixer is not None:
            self.mixer.to(device)
        self.learner = StackedQLearner(args, self.net, self.mixer, params)

        self.generators = [torch.Generator(device=device).manual_seed(
            args.seed + i) for i in range(S)]
        self.eval_generators = [torch.Generator(device=device).manual_seed(
            EVAL_SEED_OFFSET + args.seed + i) for i in range(S)]
        evals, chips = [], []
        for g in self.generators:   # the Trainer's order
            evals.append(env.init(args.evaluate_task, g, device))
            chips.append(env.init(self.B, g, device))
        self.eval_states, self.env_states = _cat(evals), _cat(chips)
        qmix = self.mixer is not None
        self.replay = init_replay(
            args.buffer_size, args.episode_limit, args.n_agents,
            args.obs_shape[-1], obs_dtype=env.params.obs_dtype,
            device=device, state_dim=args.state_shape if qmix else None,
            seeds=S)

        self.epsilon = torch.full((S,), float(args.epsilon),
                                  dtype=torch.float32, device=device)
        self.anneal_per_step = (
            (args.epsilon - args.min_epsilon) / args.anneal_steps * self.B
            if args.epsilon_anneal_scale == "step" else 0.0)
        self.updates_per_rollout = updates_per_rollout(args, self.B)
        # the rollouts take chips that _draws has reset, seed by seed
        reset = env._replace(reset=lambda states, generator: states)
        H, last = args.rnn_hidden_dim, args.last_action
        self.rollout = make_rollout(
            reset, StackedNet(self.net, self.learner.agent_params(), S), H,
            with_state=qmix, last_action=last)
        # --param_ema: evaluation and checkpoints take a moving average of
        # the params, updated once a cycle (the Trainer's)
        self.ema = None
        evaluated = self.learner.params
        if args.param_ema:
            self.ema = {k: v.clone() for k, v in params.items()}
            self.cycle_decay = float(args.param_ema) ** self.updates_per_rollout
            evaluated = self.ema
        self.eval_rollout = make_rollout(
            reset, StackedNet(self.net, self.learner.agent_params(evaluated),
                              S), H, last_action=last)

        self.time_steps = np.zeros(S, np.int64)
        self.evaluate_steps = -1
        self.curves = {name: [] for name in CURVES}   # lists of (S,)
        self.runtime = []
        self.losses = []          # each cycle's mean loss per seed (S,)
        self.n_cycles = 0
        self.model_dir = checkpoint.model_dir(args)
        self.save_path = curve_dir(args)

    # ------------------------------------------------------------------
    def _draws(self, states, generators, greedy: bool):
        """Each seed's chips reset from its generator, then its rollout's
        draws from it in the rollout's order: the reset states (S*b chips)
        and the :class:`RolloutNoise`."""
        T, N, A = self.env.episode_limit, self.env.n_agents, \
            self.env.n_actions
        resets, noise = [], []
        for st, g in zip(_split(states, self.S), generators):
            st = self.env.reset(st, g)
            b = st[0].shape[0]
            kw = dict(generator=g, device=self.device)
            steps = []
            for _ in range(T):
                if greedy:
                    steps.append((torch.rand((b, N), **kw),))
                else:
                    steps.append((torch.randint(0, A, (b, N),
                                                dtype=torch.int32, **kw),
                                  torch.rand((b, N), **kw),
                                  torch.rand((b, N), **kw)))
            resets.append(st)
            noise.append([torch.stack(x) for x in zip(*steps)])   # (T, b, N)
        fields = [torch.cat(x, dim=1) for x in zip(*noise)]
        if greedy:
            return _cat(resets), RolloutNoise(None, None, fields[0])
        return _cat(resets), RolloutNoise(*fields)

    def train_cycle(self) -> np.ndarray:
        """One collect-and-learn cycle of every seed; returns the env steps
        each counts (S,)."""
        a = self.args
        with tracing.span("train_cycle"):
            states, noise = self._draws(self.env_states, self.generators,
                                        False)
            result = self.rollout(states, None, self.epsilon,
                                  self.anneal_per_step, a.min_epsilon,
                                  noise=noise)
            self.env_states = result.env_states
            if a.epsilon_anneal_scale == "episode":
                # the Trainer's host arithmetic, seed by seed
                dec = self.B * (a.epsilon - a.min_epsilon) / a.anneal_steps
                self.epsilon = torch.tensor(
                    [float(np.float32(max(a.min_epsilon, e - dec)))
                     for e in self.epsilon.tolist()], device=self.device)
            else:
                self.epsilon = result.epsilon
            self.replay = store_stacked(self.replay, result.episodes)
            self.losses.append(self.learner.learn_many(
                self.replay, self.updates_per_rollout, self.generators))
            if self.ema is not None:
                d = self.cycle_decay
                with tracing.span("ema"), torch.no_grad():
                    for k, e in self.ema.items():
                        e.copy_(d * e + (1.0 - d) * self.learner.params[k])
            self.n_cycles += 1
            return result.steps.view(self.S, -1).sum(dim=1).cpu().numpy()

    def evaluate(self) -> dict:
        """Greedy evaluation of every seed on its evaluation chips (the EMA
        params under --param_ema); each metric (S,), keyed by its curve's
        name."""
        states, noise = self._draws(self.eval_states, self.eval_generators,
                                    True)
        result = self.eval_rollout(states, None, 0.0, 0.0, 0.0, greedy=True,
                                   noise=noise)
        self.eval_states = result.env_states
        mean = lambda x: x.view(self.S, -1).float().mean(dim=1).cpu().numpy()
        return {"Rewards": mean(result.reward), "steps": mean(result.steps),
                "constraints": mean(result.constraints),
                "success_rate": mean(result.success)}

    # ------------------------------------------------------------------
    def seed_tree(self, i: int) -> dict:
        """Seed ``i``'s checkpoint tree, in the Trainer's layout (no
        ring)."""
        tree = {
            "learner": self.learner.seed_state(i),
            "epsilon": self.epsilon[i].clone(),
            "generator": self.generators[i].get_state(),
            "net_config": {k: getattr(self.args, k) for k in NET_CONFIG},
        }
        if self.ema is not None:
            tree["ema"] = {part: {k: v[i].clone() for k, v in d.items()}
                           for part, d in _nest(self.ema).items()}
        return checkpoint.to_cpu(tree)

    def save_seeds(self, tag):
        for i in range(self.S):
            checkpoint.save(checkpoint.model_state_path(
                self.args, f"{i}_{tag}", write=True), self.seed_tree(i))

    def _farm_tree(self) -> dict:
        """The state a resume restores (tensors live, the learner's
        copies)."""
        tree = {
            "learner": self.learner.state(),
            "env_states": self.env_states._asdict(),
            "eval_states": self.eval_states._asdict(),
            "epsilon": self.epsilon,
            "generators": torch.stack([g.get_state()
                                       for g in self.generators]),
            "eval_generators": torch.stack([g.get_state()
                                            for g in self.eval_generators]),
        }
        if self.ema is not None:
            tree["ema"] = _nest(self.ema)
        if self.args.ckpt_replay:
            tree["replay"] = {"data": self.replay.data,
                              "cursor": self.replay.cursor,
                              "size": self.replay.size}
        return tree

    def _farm_path(self, tag: int) -> str:
        return os.path.join(self.model_dir, f"farm_{tag}_resume.pt")

    def save_farm(self, tag: int):
        """Write the resume checkpoint of evaluation cycle ``tag``; keep the
        two newest."""
        tree = checkpoint.to_cpu(self._farm_tree())
        tree["progress"] = {
            "time_steps": torch.from_numpy(self.time_steps.copy()),
            "runtime": torch.tensor(self.runtime, dtype=torch.float64),
            **{name: torch.from_numpy(np.stack(series, axis=1))
               for name, series in self.curves.items()}}
        checkpoint.save(self._farm_path(tag), tree)
        for old in resume_tags(self.model_dir)[:-2]:
            os.remove(self._farm_path(old))

    def load_farm(self):
        """Restore the newest readable resume checkpoint (an older one when
        the newest cannot be read)."""
        tags = resume_tags(self.model_dir)
        if not tags:
            raise FileNotFoundError(
                f"--load_model: no farm_<E>_resume.pt checkpoint under "
                f"{self.model_dir}")
        tree = None
        for tag in reversed(tags):
            path = self._farm_path(tag)
            try:
                tree = checkpoint.load(path)
                break
            except (RuntimeError, EOFError, OSError,
                    pickle.UnpicklingError) as e:
                print(f"farm resume: {path} unreadable ({e}); trying an "
                      "older one", flush=True)
        if tree is None:
            raise FileNotFoundError(
                f"--load_model: no readable farm checkpoint under "
                f"{self.model_dir} (tried {tags})")
        for flag, key, on in (("param_ema", "ema", self.ema is not None),
                              ("ckpt_replay", "replay",
                               bool(self.args.ckpt_replay))):
            if on != (key in tree):
                raise ValueError(
                    f"{path} was saved with --{flag} "
                    f"{'on' if key in tree else 'off'}, and this run has it "
                    f"{'on' if on else 'off'}; resume with the same "
                    f"--{flag}")
        template = self._farm_tree()
        got = checkpoint.restructure(
            template, {k: tree[k] for k in template if k in tree}, path)
        self.learner.load_state(got["learner"])
        self.env_states = type(self.env_states)(**got["env_states"])
        self.eval_states = type(self.eval_states)(**got["eval_states"])
        self.epsilon = got["epsilon"]
        for gens, key in ((self.generators, "generators"),
                          (self.eval_generators, "eval_generators")):
            for g, st in zip(gens, got[key]):
                g.set_state(st.clone())
        if self.ema is not None:
            with torch.no_grad():
                for k, v in _flat(got["ema"]).items():
                    self.ema[k].copy_(v)
        if "replay" in got:
            r = got["replay"]
            self.replay = ReplayState(r["data"], r["cursor"], r["size"])
        progress = tree["progress"]
        self.time_steps = progress["time_steps"].numpy().astype(np.int64)
        self.runtime = progress["runtime"].tolist()
        self.curves = {name: list(progress[name].numpy().T)
                       for name in CURVES}
        self.evaluate_steps = tag
        print(f"farm resume: restored {path} at evaluation {tag}, mean "
              f"steps {int(self.time_steps.mean())}", flush=True)

    # ------------------------------------------------------------------
    def _record(self, m: dict, elapsed: float):
        for name in CURVES:
            self.curves[name].append(m[name])
        self.runtime.append(elapsed)

    def run(self, profile_dir: Optional[str] = None) -> dict:
        """Train until the mean env steps over the seeds reach the budget,
        evaluating and checkpointing every ``evaluate_cycle`` steps (JAX
        ``run_farm``); returns the curves, each (S, E) but ``runtime``
        (E,).  ``profile_dir``: the first cycle after step 0 runs under
        ``torch.profiler``, as :meth:`Trainer.run`'s."""
        a = self.args
        if a.load_model:
            self.load_farm()
        start = time.time() - (self.runtime[-1] if self.runtime else 0.0)
        while self.time_steps.mean() < a.total_env_steps:
            if self.time_steps.mean() // a.evaluate_cycle > \
                    self.evaluate_steps:
                self.evaluate_steps += 1
                self.save_seeds(self.evaluate_steps)
                self._record(self.evaluate(), time.time() - start)
                print(f"farm eval {self.evaluate_steps}: mean steps "
                      f"{int(self.time_steps.mean())}, success "
                      f"{np.round(self.curves['success_rate'][-1], 3)}",
                      flush=True)
                self.save_farm(self.evaluate_steps)
            if profile_dir and self.time_steps.mean() > 0:
                self.time_steps += tracing.profile_to(
                    profile_dir, self.train_cycle, self.device)
                profile_dir = None
            else:
                self.time_steps += self.train_cycle()
        self.save_seeds("final")
        self._record(self.evaluate(), time.time() - start)
        curves = self.save_curves()
        print(f"seed farm done: {self.S} seeds x "
              f"{int(self.time_steps.mean())} env steps in "
              f"{time.time() - start:.1f}s; final success "
              f"{np.round(curves['success_rate'][:, -1], 3)}", flush=True)
        return curves

    def save_curves(self) -> dict:
        """``<prefix><name>_farm.npy`` of all seeds and
        ``<prefix><name>_<i>.npy`` of seed i, under the Trainer's names and
        directory."""
        curves = {name: np.stack(series, axis=1)
                  for name, series in self.curves.items()}
        curves["runtime"] = np.asarray(self.runtime)
        prefix = curve_prefix(self.args)
        os.makedirs(self.save_path, exist_ok=True)
        for name, arr in curves.items():
            np.save(os.path.join(self.save_path, f"{prefix}{name}_farm"), arr)
            for i in range(self.S):
                np.save(os.path.join(self.save_path, f"{prefix}{name}_{i}"),
                        arr[i] if arr.ndim == 2 else arr)
        return curves


def run_farm(args: Args, env: Env, n_seeds: int) -> dict:
    """Train ``n_seeds`` seeds of ``args`` in lockstep; returns the curves
    (JAX ``run_farm``)."""
    return SeedFarm(env, args, n_seeds).run()
