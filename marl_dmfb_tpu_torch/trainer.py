"""The training loop: rollout -> replay -> learn, with periodic evaluation,
checkpoints and metric curves (JAX ``trainer.py``).

The experiment protocol is the JAX package's (the reference ``train.py``'s):
train until ``total_env_steps`` env steps, evaluate and checkpoint every
``evaluate_cycle`` steps, and keep the metric curves under the same file
names.  Per cycle:

* one rollout collects B = ``args.rollout_batch`` episodes, with their
  global states under QMIX; on CUDA a DMFB env step is the hand kernel
  ``csrc/dmfb_step.cu``, a MEDA one the hand kernel ``csrc/meda_step.cu``;
* epsilon anneals by B schedule steps per lockstep step ("step"), or by B
  per cycle, clamped ("episode");
* the episodes go into the replay ring, and the learner takes
  ``max(1, round(train_time * B / n_episodes))`` updates, which keeps the
  reference's updates per collected episode;
* failed episodes count as ``episode_limit`` env steps.

A cycle is the span ``train_cycle`` (``utils/tracing.py``), which holds
the rollout's, the store's, the learner's and the EMA step's spans.

Seeds: ``args.seed`` seeds a CPU generator for the parameters, the agent's
and then a QMIX mixer's (so the weights are the same on every device), and
one on ``args.device`` for the evaluation chips, the training chips, the
rollouts' draws and the learner's minibatches, in that order; a checkpoint
holds its state in place of the JAX PRNG key.

Data parallelism (``mesh``, JAX ``trainer.py:160-246, 431-435``): every
rank draws what one device would, at the global shapes, from its generator
(alike on every rank), and keeps its rows: the training chips, the
rollouts' draws, and the evaluation chips when ``evaluate_task`` tiles the
mesh (else every rank evaluates all of them).  B and the replay capacity
are rounded up to tile the mesh.  The ring is the global one split by rows,
or under ``--local_sampling`` one local ring a rank.  The learner keeps the
parameters alike on every rank, and the host state (epsilon, the update
count, the ring's cursor and size) is alike too.  Evaluation metrics and
counted env steps are summed over the ranks; rank 0 alone prints, writes
the curves and writes the checkpoints, in which the ring and the training
chips are gathered to the one-device layout, so that a checkpoint resumes
on any number of devices.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional

import numpy as np
import torch

from marl_dmfb_tpu_torch import checkpoint
from marl_dmfb_tpu_torch import replay as replay_lib
from marl_dmfb_tpu_torch.algos.qlearn import QLearner
from marl_dmfb_tpu_torch.config import Args
from marl_dmfb_tpu_torch.envs.registry import Env
from marl_dmfb_tpu_torch.models.networks import (build_agent_net,
                                                 build_mixer, init_params)
from marl_dmfb_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                               barrier, gather_shards,
                                               shard_rows)
from marl_dmfb_tpu_torch.rollout import make_rollout, summarize_eval
from marl_dmfb_tpu_torch.utils import tracing
from marl_dmfb_tpu_torch.utils.platform import disable_tf32

NET_CONFIG = ("net", "rnn_hidden_dim", "hyper_hidden_dim", "qmix_hidden_dim",
              "two_hyper_layers")


def restore_net_config(args: Args, tag) -> Args:
    """Take the net hyperparameters from a saved checkpoint, so that a model
    trained under any hyperparameters evaluates (JAX trainer.py:146-156).
    A JAX export has no ``two_hyper_layers``; the hyperparameters' value
    stands, as in the JAX package."""
    tree = checkpoint.load(checkpoint.model_state_path(args, tag))
    for k, v in tree["net_config"].items():
        setattr(args, k, v)
    return args


def curve_dir(args: Args) -> str:
    """Where a run's curves go (reference train.py:145-158)."""
    return os.path.join(
        args.data_dir, args.result_dir.lstrip("./"), args.alg,
        f"fov{args.fov}",
        f"{args.width}by{args.length}-{args.drop_num}d{args.block_num}b")


def curve_prefix(args: Args) -> str:
    """The reference's prefix of the curves' file names
    (train.py:145-158)."""
    return (f"{args.alg}_env({args.width},{args.length},{args.drop_num},"
            f"{args.block_num},{args.fov},{args.stall})")


def _named(net: torch.nn.Module, mixer=None) -> dict:
    tree = {"agent": dict(net.named_parameters())}
    if mixer is not None:
        tree["mixer"] = dict(mixer.named_parameters())
    return tree


@torch.no_grad()
def _copy(dst: dict, src: dict):
    for part, params in dst.items():
        for k, p in params.items():
            p.copy_(src[part][k])


@torch.no_grad()
def ema_update(ema: dict, live: dict, decay: float):
    """``ema <- decay * ema + (1 - decay) * live`` in place, over trees of
    named params (``{"agent": ..., "mixer": ...}``): the cycle's EMA step,
    with the per-update decay compounded over the cycle's updates (JAX
    trainer.py:266-271)."""
    for part, params in ema.items():
        for k, e in params.items():
            e.copy_(decay * e + (1.0 - decay) * live[part][k])


def _tile(n: int, mesh: Optional[Mesh], what: str) -> int:
    """``n`` rounded up to a multiple of the mesh's size (JAX
    trainer.py:181-189, 211-219)."""
    if mesh is None or n % mesh.size == 0:
        return n
    up = -(-n // mesh.size) * mesh.size
    if mesh.rank == 0:
        print(f"mesh: rounding {what} up to {up} ({mesh.size} devices)",
              flush=True)
    return up


def updates_per_rollout(args: Args, B: int) -> int:
    """The updates a cycle of B episodes takes: the reference's updates per
    collected episode (JAX trainer.py:256-257, bench_train.py:74)."""
    return max(1, round(args.train_time * B / args.n_episodes))


class Trainer:
    def __init__(self, env: Env, args: Args, eval_only: bool = False,
                 mesh: Optional[Mesh] = None):
        """``eval_only`` builds the nets and the evaluation chips only: no
        learner, replay ring or training chips.  Under ``--alg qmix`` the
        mixer is built in either case, so that a checkpoint's mixer loads
        where its board is this one's (JAX trainer.py:172).  ``mesh``: this
        process's rank of a data-parallel run (module docstring)."""
        self.env = env
        self.args = args
        self.eval_only = eval_only
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.device = torch.device(args.device)
        disable_tf32()
        args.update_env_info(env.env_info())
        self.net = build_agent_net(args)
        self.mixer = build_mixer(args)
        g = torch.Generator().manual_seed(args.seed)
        for module in (self.net, self.mixer):
            if module is not None:
                init_params(module, g)
                module.to(self.device)
        self.learner = (None if eval_only
                        else QLearner(args, self.net, self.mixer, mesh))
        self.generator = torch.Generator(device=self.device).manual_seed(
            args.seed)
        # the evaluation chips are split when they tile the mesh, else every
        # rank evaluates all of them (JAX shard_batch's replicate rule)
        self.eval_mesh = (mesh if mesh is None
                          or args.evaluate_task % mesh.size == 0 else None)
        self.eval_states = shard_rows(self.eval_mesh, env.init(
            args.evaluate_task, self.generator, self.device))
        H = args.rnn_hidden_dim
        qmix = self.mixer is not None
        self.rollout = make_rollout(env, self.net, H, with_state=qmix,
                                    last_action=args.last_action, mesh=mesh)
        self.eval_rollout = (
            self.rollout if self.eval_mesh is mesh else
            make_rollout(env, self.net, H, last_action=args.last_action))
        self.B = B = _tile(args.rollout_batch, mesh, "rollout batch")
        self.env_states = self.replay = None
        if not eval_only:
            self.env_states = shard_rows(mesh, env.init(
                B, self.generator, self.device))
            capacity = _tile(args.buffer_size, mesh, "replay capacity")
            self.replay = replay_lib.init_replay(
                capacity // (1 if mesh is None else mesh.size),
                args.episode_limit, args.n_agents,
                args.obs_shape[-1], obs_dtype=env.params.obs_dtype,
                device=self.device,
                state_dim=args.state_shape if qmix else None)
        # --local_sampling pairs the local rings' store with the learner's
        # local sampling (replay.py)
        self._store = (replay_lib.store_local
                       if mesh is not None and args.local_sampling
                       else replay_lib.store)

        self.epsilon = args.epsilon
        self.anneal_per_step = (
            (args.epsilon - args.min_epsilon) / args.anneal_steps * B
            if args.epsilon_anneal_scale == "step" else 0.0)
        self.updates_per_rollout = updates_per_rollout(args, B)

        # --param_ema: evaluation and checkpoints use a moving average of
        # the params (the agent's and the mixer's), updated once a cycle
        # with the per-update decay compounded over the cycle's updates
        self.ema_net = self.ema_mixer = self.ema_rollout = None
        if args.param_ema and not eval_only:
            self.ema_net = copy.deepcopy(self.net).requires_grad_(False)
            if self.mixer is not None:
                self.ema_mixer = copy.deepcopy(
                    self.mixer).requires_grad_(False)
            self.ema_rollout = make_rollout(env, self.ema_net, H,
                                            last_action=args.last_action,
                                            mesh=self.eval_mesh)
            self.cycle_decay = float(args.param_ema) ** self.updates_per_rollout

        # metric curves (reference train.py:21-25)
        self.episode_rewards = []
        self.episode_steps = []
        self.episode_constraints = []
        self.success_rate = []
        self.time_cost = []
        self.losses = []          # mean loss of each cycle (device tensors)
        self.n_cycles = 0

        self.save_path = curve_dir(args)

    # ------------------------------------------------------------------
    def evaluate(self) -> dict:
        """Greedy evaluation over fresh random tasks on the evaluation chips
        (JAX trainer.py:300-315), with the EMA params under --param_ema."""
        rollout = (self.eval_rollout if self.ema_net is None
                   else self.ema_rollout)
        result = rollout(self.eval_states, self.generator, 0.0, 0.0, 0.0,
                         greedy=True)
        self.eval_states = result.env_states
        return summarize_eval(result, self.eval_mesh)

    def _tree(self, gathered: bool = True) -> dict:
        """The checkpoint tree, its tensors live (the learner's are
        copies).  Under a mesh the ring and the training chips are this
        rank's rows, or with ``gathered`` (a collective) the global
        arrays."""
        a = self.args
        tree = {
            "learner": self.learner.state(),
            "epsilon": torch.as_tensor(self.epsilon,
                                       dtype=torch.float32).cpu(),
            "generator": self.generator.get_state(),
            "net_config": {k: getattr(a, k) for k in NET_CONFIG},
        }
        if self.ema_net is not None:
            tree["ema"] = _named(self.ema_net, self.ema_mixer)
        if a.ckpt_replay:
            data, chips = self.replay.data, self.env_states._asdict()
            if self.mesh is not None and gathered:
                data = gather_shards(self.mesh, data)
                chips = gather_shards(self.mesh, chips)
            tree["replay"] = {"data": data, "cursor": self.replay.cursor,
                              "size": self.replay.size}
            tree["env_states"] = chips
        return tree

    def save_model(self, tag) -> str:
        """Checkpoint the full training state (JAX trainer.py:317-350);
        under a mesh every rank calls it and rank 0 writes."""
        if self.learner is None:
            raise RuntimeError("Trainer was built with eval_only=True")
        path = checkpoint.model_state_path(self.args, tag, write=True)
        tree = self._tree()
        if self.is_main:
            checkpoint.save(path, checkpoint.to_cpu(tree))
        barrier(self.mesh)
        return path

    def _set_params(self, params: dict, target: dict):
        _copy(_named(self.net, self.mixer), params)
        if self.learner is not None:
            _copy(_named(self.learner.target_net, self.learner.target_mixer),
                  target)

    def _restructure_params(self, data: dict, path: str) -> dict:
        """Saved params laid out as this trainer's.  The agent must match
        exactly.  A QMIX mixer's first layers are ``state_dim`` wide, so
        one trained on another board does not fit this one: greedy
        evaluation never calls the mixer, so it is dropped and this
        trainer's fresh mixer kept (JAX trainer.py:373-390)."""
        template = _named(self.net, self.mixer)
        if self.mixer is None or "mixer" not in data:
            return checkpoint.restructure(template, data, path)
        out = {"agent": checkpoint.restructure(template["agent"],
                                               data["agent"], path)}
        try:
            out["mixer"] = checkpoint.restructure(template["mixer"],
                                                  data["mixer"], path)
        except ValueError:
            print("load_model: the QMIX mixer's shape is tied to the "
                  "training board; keeping a fresh mixer (greedy evaluation "
                  "does not call it) for this board size", flush=True)
            out["mixer"] = {k: v.detach().clone()
                            for k, v in template["mixer"].items()}
        return out

    def load_model(self, tag, params_only: bool = False):
        """Restore a checkpoint (JAX trainer.py:352-454).

        ``params_only`` takes the params and target params only (the EMA,
        where the checkpoint has one), which is what evaluation needs, and
        drops this process's EMA, so that evaluation scores exactly the
        checkpoint's weights.  A full restore resumes training: it requires
        the checkpoint to have been saved with this run's --param_ema and
        --ckpt_replay, and restores the optimizer, epsilon and the
        generator, and under --ckpt_replay the replay ring and the training
        chips.

        The checkpoint may also be a JAX checkpoint exported to ``.npz``
        (``checkpoint.model_state_path``): a deploy export holds one set of
        weights, which a params-only load takes for both nets; a full
        export resumes as a ``.pt`` does, except that the generator keeps
        this run's state (a JAX PRNG key has no torch counterpart)."""
        path = checkpoint.model_state_path(self.args, tag)
        tree = checkpoint.load(path)
        if params_only:
            if "ema" in tree:
                ema = self._restructure_params(tree["ema"], path)
                self._set_params(ema, ema)
            else:
                learner = tree["learner"]
                self._set_params(
                    self._restructure_params(learner["params"], path),
                    self._restructure_params(
                        learner.get("target_params", learner["params"]),
                        path))
                if self.learner is not None:
                    self.learner.train_step = int(learner["train_step"])
            self.ema_net = self.ema_mixer = None
            self.epsilon = tree["epsilon"]
            return
        if self.learner is None:
            raise RuntimeError("Trainer was built with eval_only=True")
        for flag, key, on in (("param_ema", "ema", self.ema_net is not None),
                              ("ckpt_replay", "replay",
                               bool(self.args.ckpt_replay))):
            if on != (key in tree):
                raise ValueError(
                    f"{path} was saved with --{flag} "
                    f"{'on' if key in tree else 'off'}, and this run has it "
                    f"{'on' if on else 'off'}; resume with the same "
                    f"--{flag}")
        if self.mesh is not None and "replay" in tree:
            # a checkpoint holds the one-device layout: take this rank's rows
            tree["replay"]["data"] = shard_rows(self.mesh,
                                                tree["replay"]["data"])
            tree["env_states"] = shard_rows(self.mesh, tree["env_states"])
        template = self._tree(gathered=False)
        if path.endswith(".npz"):
            del template["generator"]
        # the net config was read by restore_net_config, and the params'
        # shapes hold it; a JAX export's has fewer keys than the port's
        template.pop("net_config")
        tree = checkpoint.restructure(
            template, {k: v for k, v in tree.items() if k != "net_config"},
            path)
        self.learner.load_state(tree["learner"])
        if self.ema_net is not None:
            _copy(_named(self.ema_net, self.ema_mixer), tree["ema"])
        if "replay" in tree:
            r = tree["replay"]
            self.replay = replay_lib.ReplayState(r["data"], r["cursor"],
                                                 r["size"])
            self.env_states = type(self.env_states)(**tree["env_states"])
        self.epsilon = tree["epsilon"]
        if "generator" in tree:
            self.generator.set_state(tree["generator"])

    # ------------------------------------------------------------------
    def train_cycle(self) -> int:
        """One collect-and-learn cycle; returns the env steps it counts."""
        if self.learner is None:
            raise RuntimeError("Trainer was built with eval_only=True")
        a = self.args
        with tracing.span("train_cycle"):
            result = self.rollout(self.env_states, self.generator,
                                  self.epsilon, self.anneal_per_step,
                                  a.min_epsilon)
            self.env_states = result.env_states
            if a.epsilon_anneal_scale == "episode":
                # the reference decrements once per generated episode
                # (rollout.py:126-127 with train.py:59-66)
                dec = self.B * (a.epsilon - a.min_epsilon) / a.anneal_steps
                self.epsilon = float(np.float32(
                    max(a.min_epsilon, float(self.epsilon) - dec)))
            else:
                self.epsilon = result.epsilon
            self.replay = self._store(self.replay, result.episodes,
                                      self.mesh)
            self.losses.append(self.learner.learn_many(
                self.replay, self.updates_per_rollout, self.generator))
            if self.ema_net is not None:
                self.ema_step()
            self.n_cycles += 1
            return int(all_reduce_sum(self.mesh, result.steps.sum()))

    def ema_step(self):
        """The cycle's EMA step (``--param_ema``) over the agent's params
        and a QMIX mixer's (JAX trainer.py:260-274)."""
        with tracing.span("ema"):
            ema_update(_named(self.ema_net, self.ema_mixer),
                       _named(self.net, self.mixer), self.cycle_decay)

    def _append(self, m: dict):
        self.episode_rewards.append(m["reward"])
        self.episode_steps.append(m["steps"])
        self.episode_constraints.append(m["constraints"])
        self.success_rate.append(m["success_rate"])

    def _record(self, m: dict):
        self._append(m)
        if self.is_main:
            self.plot()
            self.save_curves()

    def run(self, online_evaluate: bool = True,
            profile_dir: Optional[str] = None) -> dict:
        """The main loop (JAX trainer.py:494-563, reference
        train.py:32-93).

        ``profile_dir``: the first cycle after step 0 runs under
        ``torch.profiler``, which writes its Chrome trace and the spans'
        summary there (``tracing.profile_to``; under a mesh each rank
        under ``rank<r>/``)."""
        args = self.args
        if profile_dir and self.mesh is not None:
            profile_dir = os.path.join(profile_dir, f"rank{self.mesh.rank}")
        time_steps, evaluate_steps = 0, -1
        start = time.time()
        while time_steps < args.total_env_steps:
            if time_steps // args.evaluate_cycle > evaluate_steps:
                evaluate_steps += 1
                self.time_cost.append(time.time() - start)
                self.save_model(evaluate_steps)
                if online_evaluate:
                    self._record(self.evaluate())
                if self.is_main:
                    print(f"Run {args.ith_run}, time_steps {time_steps}, "
                          f"evaluate {evaluate_steps}, "
                          f"elapsed {self.time_cost[-1]:.1f}s"
                          + (f", success {self.success_rate[-1]:.3f}"
                             if online_evaluate and self.success_rate
                             else ""), flush=True)
            if profile_dir and time_steps > 0:
                time_steps += tracing.profile_to(profile_dir,
                                                 self.train_cycle,
                                                 self.device)
                profile_dir = None
            else:
                time_steps += self.train_cycle()
        self.save_model("final")
        self.time_cost.append(time.time() - start)
        if online_evaluate:
            self._record(self.evaluate())
        else:
            self.evaluate_total()
        return {
            "rewards": self.episode_rewards,
            "steps": self.episode_steps,
            "constraints": self.episode_constraints,
            "success_rate": self.success_rate,
            "runtime": self.time_cost,
            "loss": torch.stack(self.losses).tolist() if self.losses else [],
        }

    def evaluate_total(self):
        """Reload every saved checkpoint and evaluate it (reference
        train.py:96-118; the ``--online_eval`` off path)."""
        args = self.args
        for series in (self.episode_rewards, self.episode_steps,
                       self.episode_constraints, self.success_rate):
            series.clear()
        tags = list(range(args.total_env_steps // args.evaluate_cycle))
        for tag in tags + ["final"]:
            try:
                self.load_model(tag, params_only=True)
            except FileNotFoundError:
                continue
            m = self.evaluate()
            self._append(m)
            if self.is_main:
                print(f"checkpoint {tag}: success {m['success_rate']:.3f}",
                      flush=True)
        if self.is_main:
            self.plot()
            self.save_curves()

    # ------------------------------------------------------------------
    def plot(self):
        """The JAX package draws the curves into ``plt_<run>.png`` with
        matplotlib, which the port does not import (the GPU machine has
        none); the ``.npy`` curves of :meth:`save_curves` are the record."""
        print(f"plot: plt_{self.args.ith_run}.png not written (the port "
              "draws no plots); the .npy curves are in "
              f"{self.save_path}", flush=True)

    def save_curves(self):
        """The curves as ``.npy`` files with the reference's names
        (train.py:145-158)."""
        prefix = curve_prefix(self.args)
        num = self.args.ith_run
        os.makedirs(self.save_path, exist_ok=True)
        for name, series in [
            (f"{prefix}Rewards_{num}", self.episode_rewards),
            (f"{prefix}steps_{num}", self.episode_steps),
            (f"{prefix}constraints_{num}", self.episode_constraints),
            (f"{prefix}success_rate_{num}", self.success_rate),
            (f"{prefix}runtime_{num}", self.time_cost),
        ]:
            np.save(os.path.join(self.save_path, name), np.asarray(series))
