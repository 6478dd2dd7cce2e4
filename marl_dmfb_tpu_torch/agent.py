"""The reference's per-agent action-selection facade (``agent/agent.py``;
JAX ``agent.py``).

A stateful wrapper with the reference ``Agents`` API, for drop-in
migration and interactive use: ``choose_action`` runs one GRU step for one
agent, keeping each agent's ``eval_hidden`` (agent.py:33-41), and
``train`` hands a batch to the VDN or QMIX learner (agent.py:63-70).  The
port's training does not go through it: the rollout and the learner take
whole batches (``rollout.py``, ``algos/qlearn.py``).

The weights come from a CPU generator seeded ``args.seed``, as the
Trainer's do, and sit on ``args.device`` (the GPU unless ``cpu``);
exploration draws come from ``numpy.random.RandomState(args.seed)``, in
the JAX facade's order.
"""

from __future__ import annotations

import numpy as np
import torch

from marl_dmfb_tpu_torch.algos.qlearn import QLearner
from marl_dmfb_tpu_torch.models.networks import (build_agent_net,
                                                 build_mixer, init_params)
from marl_dmfb_tpu_torch.utils.platform import select_device

# the learner's fields of an episode batch (the rest of the reference's
# layout, avail_u, avail_u_next and u_onehot, the learner derives)
BATCH_KEYS = ("o_ext", "u", "r", "padded", "terminated", "s_ext")


class Agents:
    def __init__(self, args, env=None):
        if args.alg not in ("vdn", "qmix"):
            raise Exception("No such algorithm")   # agent.py:18-19
        self.args = args
        self.n_actions = args.n_actions
        self.n_agents = args.n_agents
        self.device = select_device(args.device)
        g = torch.Generator().manual_seed(args.seed)
        net = init_params(build_agent_net(args), g)
        mixer = build_mixer(args)
        if mixer is not None:
            init_params(mixer, g).to(self.device)
        self.net = net.to(self.device)
        self.learner = QLearner(args, self.net, mixer)
        self.eval_hidden = None
        self.init_hidden(1)
        self._rng = np.random.RandomState(args.seed)

    # -- the reference's policy surface ----------------------------------
    def init_hidden(self, episode_num: int):
        """(vdn.py:198-203)"""
        self.eval_hidden = torch.zeros(
            (episode_num, self.n_agents, self.args.rnn_hidden_dim),
            device=self.device)

    @torch.no_grad()
    def choose_action(self, obs, last_action, agent_num, avail_actions,
                      epsilon, evaluate=False) -> int:
        """One agent's epsilon-greedy action (agent.py:22-48)."""
        inputs = np.asarray(obs, np.float32)
        if self.args.last_action:
            inputs = np.hstack([inputs, np.asarray(last_action, np.float32)])
        x = torch.from_numpy(inputs)[None].to(self.device)
        q, h = self.net(x, self.eval_hidden[:, agent_num, :])
        self.eval_hidden[:, agent_num, :] = h
        avail = np.asarray(avail_actions, np.float32)
        q = np.where(avail == 0.0, -np.inf, q[0].cpu().numpy())
        if self._rng.uniform() < epsilon and not evaluate:
            return int(self._rng.choice(np.nonzero(avail)[0]))
        return int(np.argmax(q))

    def train(self, batch: dict, train_step: int, epsilon=None) -> float:
        """One learner update on an episode batch (agent.py:63-70); returns
        the loss.

        Takes the port's episode layout (``o_ext``, ...) or the
        reference's (``o``, ``o_next``, ``avail_u``, ``u_onehot``, ...),
        whose ``o`` and ``o_next`` make ``o_ext``; the masked loss is the
        same either way."""
        batch = dict(batch)
        if "o_ext" not in batch:
            o = np.asarray(batch.pop("o"))
            o_next = np.asarray(batch.pop("o_next"))
            batch["o_ext"] = np.concatenate([o, o_next[:, -1:]], axis=1)
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in batch.items() if k in BATCH_KEYS}
        return float(self.learner.update(batch))
