"""A PettingZoo-style interactive wrapper over the batched envs (JAX
``envs/pettingzoo_shim.py``).

The reference's envs implement PettingZoo's ``ParallelEnv`` dict API
(``env/DMFB/dmfb.py:474-640``, ``env/MEDA/meda.py:457-681``).  The port
works on batches of chips; this shim gives one chip (a batch of one) the
stateful, dict-keyed interface, for interactive use, notebooks and drop-in
migration::

    env = ParallelEnvShim(make_env("dmfb", ...), seed=0)
    obs = env.reset()
    obs, rewards, dones, info = env.step({"player_0": 1, ...})

Agents are named ``player_{i}`` as in the reference (dmfb.py:493).  The
chip's randomness (tasks, move success) comes from a generator seeded
``seed`` on ``device``; ``seed()`` reseeds it.  The chip lives on the GPU
unless ``device="cpu"`` is given (raising where CUDA is asked for and
absent); on CUDA a DMFB step is the ``dmfb_step`` kernel at a batch of
one.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from marl_dmfb_tpu_torch.envs import dmfb as _dmfb
from marl_dmfb_tpu_torch.envs.registry import Env
from marl_dmfb_tpu_torch.utils.platform import select_device


class ParallelEnvShim:
    metadata = {"render.modes": ["human", "rgb_array"]}

    def __init__(self, env: Env, seed: int = 0, show: bool = False,
                 savemp4: Union[bool, str] = False, device="cuda"):
        self.env = env
        self.device = select_device(device)
        self.agents = [f"player_{i}" for i in range(env.n_agents)]
        self.possible_agents = self.agents[:]
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state = env.init(1, self.generator, self.device)
        self.rewards = {a: 0.0 for a in self.agents}
        self.dones = {a: False for a in self.agents}
        self._renderer = None
        if show or savemp4:
            from marl_dmfb_tpu_torch.render import Renderer

            self._renderer = Renderer(
                env, show=show,
                save_path=savemp4 if isinstance(savemp4, str) else None)

    def _observe(self) -> List[np.ndarray]:
        obs = self.env.observe(self._state)[0].cpu().numpy()
        return [obs[i] for i in range(len(self.agents))]

    def _clear(self):
        self.rewards = {a: 0.0 for a in self.agents}
        self.dones = {a: False for a in self.agents}

    # -- PettingZoo ParallelEnv surface ---------------------------------
    def reset(self, new: bool = False) -> List[np.ndarray]:
        """A new task; the wear maps persist, or with ``new`` (DMFB) start
        fresh (JAX ``dmfb.reset(new=True)``)."""
        state = self.env.reset(self._state, self.generator)
        if new and self.env.name == "dmfb":
            p = self.env.params
            state = state._replace(
                health=torch.ones_like(state.health),
                usage=torch.zeros_like(state.usage),
                degrade=_dmfb.random_degrade_map(p, 1, self.generator,
                                                 self.device))
        self._state = state
        self._clear()
        obs = self._observe()
        self.render()
        return obs

    def restart(self) -> List[np.ndarray]:
        """The same task from its start."""
        self._state = self.env.restart(self._state)
        self._clear()
        return self._observe()

    def step(self, actions):
        if isinstance(actions, dict):
            acts = [actions[a] for a in self.agents]
        elif isinstance(actions, (list, tuple, np.ndarray)):
            acts = list(actions)
        else:
            raise TypeError("wrong actions")
        a = torch.tensor([acts], dtype=torch.int32, device=self.device)
        self._state, out = self.env.step(self._state, a, self.generator)
        obs = out.obs[0].cpu().numpy()
        rewards = out.rewards[0].cpu().tolist()
        dones = out.dones[0].cpu().tolist()
        for i, name in enumerate(self.agents):
            self.rewards[name] = float(rewards[i])
            self.dones[name] = bool(dones[i])
        info = {"constraints": int(out.constraints[0]),
                "success": int(out.success[0])}
        self.render()
        return ([obs[i] for i in range(len(self.agents))],
                dict(self.rewards), dict(self.dones), info)

    def get_env_info(self) -> dict:
        return self.env.env_info()

    def render(self, close: bool = False):
        if self._renderer is None:
            return
        if close:
            self._renderer.close()
            return
        self._renderer.draw(self._state)

    def seed(self, seed: Optional[int] = None):
        """Reseed the chip's generator."""
        if seed is not None:
            self.generator.manual_seed(seed)

    def close(self):
        self.render(close=True)

    # -- extras ---------------------------------------------------------
    @property
    def state(self):
        """The env state, a batch of one chip."""
        return self._state

    @state.setter
    def state(self, state):
        self._state = state

    def global_state(self) -> np.ndarray:
        return self.env.global_state(self._state)[0].cpu().numpy()
