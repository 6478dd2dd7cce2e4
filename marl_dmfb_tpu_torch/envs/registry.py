"""Uniform functional API over the biochip environments (JAX
``envs/registry.py:19-94``).

``make_env`` returns an :class:`Env`: functions closed over the static
params, each taking a batch of B chips.  ``step_core`` is the production env
step: on CUDA tensors it launches the hand kernel (for the v0.1 observation,
its no-observation mode, then the plain v0.1 ``observe``), on CPU tensors it
runs the kernel's plain PyTorch version (``ops/dmfb_step.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from marl_dmfb_tpu_torch.envs import dmfb as _dmfb
from marl_dmfb_tpu_torch.ops import dmfb_step as _dmfb_step


class Env(NamedTuple):
    name: str
    params: Any
    init: Callable       # (batch, generator, device) -> state
    reset: Callable      # (state, generator) -> state
    restart: Callable    # (state) -> state
    step: Callable       # (state, actions, generator) -> (state, StepOutput)
    step_core: Callable  # (state, actions, uniforms) -> (state, StepOutput)
    observe: Callable    # (state) -> (B, N, obs_dim)

    @property
    def n_agents(self) -> int:
        return self.params.n_droplets

    @property
    def n_actions(self) -> int:
        return _dmfb.N_ACTIONS

    @property
    def episode_limit(self) -> int:
        return self.params.episode_limit

    def env_info(self) -> dict:
        return self.params.env_info()


def _step(params, state, actions, generator):
    """``dmfb.step`` through the kernel dispatch."""
    uniforms = torch.rand(actions.shape, generator=generator,
                          device=actions.device)
    return _dmfb_step.step_batch(params, state, actions, uniforms)


def make_env(name: str = "dmfb", version: str | None = None,
             **kwargs) -> Env:
    """Build an environment bundle.  ``version`` follows the CLI: for DMFB,
    ``'0.1'`` selects the 4-layer float32 observation, anything else the v0
    int8 one; ``obs_version`` ("v0", "v0.1") names it directly.  MEDA is
    not ported yet."""
    obs_version = kwargs.pop("obs_version", None)
    if obs_version is None:
        obs_version = {"0.1": "v0.1", "0.2": "v0.2"}.get(version or "", "v0")
    if name == "meda":
        raise NotImplementedError(
            "the MEDA env is not ported yet; see ROADMAP.md")
    if name != "dmfb":
        raise ValueError(f"unknown env name: {name!r}")
    if obs_version == "v0.2":
        raise ValueError("dmfb has no v0.2 observation")
    params = _dmfb.DMFBParams(obs_version=obs_version, **kwargs)
    return Env(
        name="dmfb",
        params=params,
        init=functools.partial(_dmfb.init, params),
        reset=functools.partial(_dmfb.reset, params),
        restart=functools.partial(_dmfb.restart, params),
        step=functools.partial(_step, params),
        step_core=functools.partial(_dmfb_step.step_batch, params),
        observe=functools.partial(_dmfb.observe, params),
    )
