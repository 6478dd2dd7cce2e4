"""Uniform functional API over the biochip environments (JAX
``envs/registry.py:19-94``).

``make_env`` returns an :class:`Env`: functions closed over the static
params, each taking a batch of B chips.  ``step_core`` is the production env
step, and ``step`` draws the move-success uniforms and calls it.  On CUDA
tensors it launches a hand kernel, on CPU tensors it runs the kernel's
plain PyTorch version: for DMFB the kernels of ``ops/dmfb_step.py`` (for
the v0.1 observation, in their no-observation mode, then the plain v0.1
``observe``); for MEDA, which the JAX package ran as plain XLA code with
no Pallas kernel, the kernel of ``ops/meda_step.py`` (every observation
version), whose plain version is ``envs/meda.step_core``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from marl_dmfb_tpu_torch.envs import dmfb as _dmfb
from marl_dmfb_tpu_torch.envs import meda as _meda
from marl_dmfb_tpu_torch.ops import dmfb_step as _dmfb_step
from marl_dmfb_tpu_torch.ops import meda_step as _meda_step


class Env(NamedTuple):
    name: str
    params: Any
    init: Callable          # (batch, generator, device) -> state
    reset: Callable         # (state, generator) -> state
    restart: Callable       # (state) -> state
    step: Callable          # (state, actions, generator) -> (state, out)
    step_core: Callable     # (state, actions, uniforms) -> (state, out)
    observe: Callable       # (state) -> (B, N, obs_dim)
    global_state: Callable  # (state) -> (B, state_dim) int8

    @property
    def n_agents(self) -> int:
        return self.params.n_droplets

    @property
    def n_actions(self) -> int:
        return _dmfb.N_ACTIONS if self.name == "dmfb" else _meda.N_ACTIONS

    @property
    def episode_limit(self) -> int:
        return self.params.episode_limit

    def env_info(self) -> dict:
        return self.params.env_info()


def _drawing(step_batch):
    """``step`` (the env module's, with draws from ``generator``) through
    the kernel dispatch ``step_batch``."""
    def step(params, state, actions, generator):
        uniforms = torch.rand(actions.shape, generator=generator,
                              device=actions.device)
        return step_batch(params, state, actions, uniforms)

    return step


_FUNCTIONS = ("init", "reset", "restart", "step", "step_core", "observe",
              "global_state")


def _bind(name: str, module, params, **overrides) -> Env:
    """An :class:`Env` of ``module``'s functions closed over ``params``;
    ``overrides`` replace some of them."""
    fns = {f: overrides.get(f, getattr(module, f)) for f in _FUNCTIONS}
    return Env(name=name, params=params,
               **{f: functools.partial(fn, params) for f, fn in fns.items()})


def make_env(name: str = "dmfb", version: str | None = None,
             **kwargs) -> Env:
    """Build an environment bundle.  ``version`` follows the CLI: for DMFB,
    ``'0.1'`` selects the 4-layer float32 observation, anything else the v0
    int8 one; for MEDA, ``'0.1'`` and ``'0.2'`` select those observations
    and anything else v0 (the MEDA CLI sets ``'0.2'``).  ``obs_version``
    ("v0", "v0.1", "v0.2") names it directly."""
    obs_version = kwargs.pop("obs_version", None)
    if obs_version is None:
        obs_version = {"0.1": "v0.1", "0.2": "v0.2"}.get(version or "", "v0")
    if name == "meda":
        return _bind("meda", _meda,
                     _meda.MEDAParams(obs_version=obs_version, **kwargs),
                     step=_drawing(_meda_step.step_batch),
                     step_core=_meda_step.step_batch)
    if name != "dmfb":
        raise ValueError(f"unknown env name: {name!r}")
    if obs_version == "v0.2":
        raise ValueError("dmfb has no v0.2 observation")
    return _bind("dmfb", _dmfb,
                 _dmfb.DMFBParams(obs_version=obs_version, **kwargs),
                 step=_drawing(_dmfb_step.step_batch),
                 step_core=_dmfb_step.step_batch)
