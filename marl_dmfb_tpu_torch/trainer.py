"""Evaluation loop (the eval-only part of JAX ``trainer.py``).

``Trainer(env, args, eval_only=True)`` builds the agent net with seeded
random weights (or takes weights through ``load_state_dict``), draws
``evaluate_task`` evaluation chips, and ``evaluate()`` runs the greedy
rollout over fresh tasks on them.  Training — replay, the VDN learner, the
optimizer and checkpoints — is not ported yet.

Seeds: the JAX trainer splits ``PRNGKey(args.seed)`` into the parameter,
env and evaluation keys.  Here ``args.seed`` seeds two explicit generators:
a CPU one for the parameters (so the weights are the same on every device)
and one on ``args.device`` for the chips' tasks and the env's draws.
"""

from __future__ import annotations

import torch

from marl_dmfb_tpu_torch.config import Args
from marl_dmfb_tpu_torch.envs.registry import Env
from marl_dmfb_tpu_torch.models.networks import build_agent_net, init_params
from marl_dmfb_tpu_torch.rollout import make_rollout, summarize_eval


class Trainer:
    def __init__(self, env: Env, args: Args, eval_only: bool = True):
        if not eval_only:
            raise NotImplementedError(
                "training (replay, VDN learner, Adam, checkpoints) is not "
                "ported yet; see ROADMAP.md Queue 1 items 4-6")
        self.env = env
        self.args = args
        self.device = torch.device(args.device)
        args.update_env_info(env.env_info())
        self.net = build_agent_net(args)
        init_params(self.net, torch.Generator().manual_seed(args.seed))
        self.net.to(self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(
            args.seed)
        self.eval_states = env.init(args.evaluate_task, self.generator,
                                    self.device)
        self.rollout = make_rollout(env, self.net, args.rnn_hidden_dim)

    def evaluate(self) -> dict:
        """Greedy evaluation over fresh random tasks on the evaluation chips
        (JAX trainer.py:300-315)."""
        result = self.rollout(self.eval_states, self.generator, 0.0, 0.0,
                              0.0, greedy=True)
        self.eval_states = result.env_states
        return summarize_eval(result)
