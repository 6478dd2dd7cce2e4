"""The ranks' side of the data-parallel tests (``tests/test_torch_mesh*.py``):
functions that ``marl_dmfb_tpu_torch.parallel.distributed.spawn`` runs in
each rank of a gloo group on the CPU.  Each writes what it computed to
``<out>/rank<r>.pt`` for the test process to compare.  This module imports
torch and the port only, so that a rank starts without JAX."""

import os

import torch

from marl_dmfb_tpu_torch import replay as replay_lib
from marl_dmfb_tpu_torch.algos.qlearn import QLearner
from marl_dmfb_tpu_torch.config import make_env_from_args
from marl_dmfb_tpu_torch.models.networks import build_agent_net, build_mixer
from marl_dmfb_tpu_torch.parallel.mesh import shard_rows
from marl_dmfb_tpu_torch.rollout import make_rollout
from marl_dmfb_tpu_torch.trainer import Trainer


def _save(mesh, out, record):
    torch.save(record, os.path.join(out, f"rank{mesh.rank}.pt"))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def composed(mesh, args, state, cycles, local, out):
    """Rollout -> store -> ``learn_many`` per cycle from the learner state
    ``state``, with the draws of each of ``cycles`` replayed: ``reset`` (the
    global batch's reset chips), ``noise`` (global), ``idx`` (the whole
    minibatches', or under ``local`` each rank's, indexed by rank), ``eps``
    and ``anneal``.  Records each cycle's episodes, epsilon, ring, loss and
    learner state."""
    env = make_env_from_args(args)
    learner = QLearner(args, build_agent_net(args), build_mixer(args), mesh)
    learner.load_state(state)
    qmix = args.alg == "qmix"
    ring = replay_lib.init_replay(
        args.buffer_size // mesh.size, args.episode_limit, args.n_agents,
        args.obs_shape[-1], obs_dtype=env.params.obs_dtype,
        state_dim=args.state_shape if qmix else None)
    store = replay_lib.store_local if local else replay_lib.store
    record = []
    for c in cycles:
        roll = make_rollout(env._replace(reset=lambda s, g, r=c["reset"]: r),
                            learner.net, args.rnn_hidden_dim,
                            with_state=qmix, mesh=mesh)
        res = roll(shard_rows(mesh, c["reset"]), None, c["eps"],
                   c["anneal"], 0.05, noise=c["noise"])
        ring = store(ring, res.episodes, mesh)
        idx = c["idx"][mesh.rank] if local else c["idx"]
        loss = learner.learn_many(ring, idx.shape[0], idx=idx)
        record.append(dict(episodes=res.episodes, epsilon=res.epsilon,
                           ring=_clone(ring.data), cursor=ring.cursor,
                           size=ring.size, loss=loss,
                           state=learner.state()))
    _save(mesh, out, record)


def _snapshot(trainer, steps):
    return dict(steps=steps, loss=trainer.losses[-1],
                epsilon=float(trainer.epsilon),
                state=trainer.learner.state(),
                ring=_clone(trainer.replay.data),
                cursor=trainer.replay.cursor, size=trainer.replay.size,
                env_states=_clone(trainer.env_states._asdict()))


def trainer_cycles(mesh, args, n_cycles, out, save_after=None,
                   resume_from=None):
    """``Trainer(env, args, mesh)``, its B, ring rows and evaluation rows,
    and ``n_cycles`` train cycles, each recorded; then one evaluation.
    ``save_after`` k: checkpoint ``"mesh"`` after cycle k.  ``resume_from``
    a tag: afterwards a fresh Trainer loads that checkpoint and runs one
    cycle, recorded as ``resumed``."""
    env = make_env_from_args(args)
    trainer = Trainer(env, args, mesh=mesh)
    record = dict(B=trainer.B, ring_rows=trainer.replay.data["u"].shape[0],
                  eval_rows=trainer.eval_states[0].shape[0], cycles=[])
    for k in range(n_cycles):
        steps = trainer.train_cycle()
        record["cycles"].append(_snapshot(trainer, steps))
        if save_after == k + 1:
            trainer.save_model("mesh")
    record["eval"] = trainer.evaluate()
    if resume_from is not None:
        again = Trainer(env, args, mesh=mesh)
        again.load_model(resume_from)
        steps = again.train_cycle()
        record["resumed"] = _snapshot(again, steps)
    _save(mesh, out, record)
