"""Wrapper of the fused MEDA step kernel (``csrc/meda_step.cu``).

The JAX package has no Pallas kernel for MEDA: XLA compiled its plain
step.  On the card the port's plain version (``envs/meda.step_core``) is
some 275 small launches a step, so the port takes this kernel as its MEDA
env step.

:func:`step_batch` takes a batched :class:`MEDAState`, actions and
move-success draws, and returns what ``envs.meda.step_core`` returns,
bitwise but for ``team_reward`` (a float32 mean summed in another order).
On CPU tensors it runs that plain version; on CUDA tensors it launches the
kernel (built on first use) or raises.  The observation version is the
kernel's template parameter.  The kernel has no compile-time bound on the
shape; a chip's droplets and one agent's observation row have to fit in a
block's shared memory, which every board up to thousands of droplets does
(past it the launch returns ``cudaErrorInvalidValue`` and the wrapper
raises).  ``launches`` counts the kernel's launches; each adds the batch
to the counter ``env.meda_step.chips`` (``utils/tracing.py``).
"""

from __future__ import annotations

import ctypes

import torch

from marl_dmfb_tpu_torch.envs import meda
from marl_dmfb_tpu_torch.ops import _build, check_tensors
from marl_dmfb_tpu_torch.utils import tracing

launches = 0   # kernel launches since import (reset by callers that count)

VERSIONS = {"v0": 0, "v0.1": 1, "v0.2": 2}   # the kernel's VERSION

_ARGTYPES = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def direction_reciprocals(params: meda.MEDAParams) -> tuple:
    """The float32 scales of the observation's direction (y, x): 1/width
    and 1/length for v0.1, the v0.2 zoom's 1/(extent/30); v0 has none."""
    if params.obs_version == "v0.1":
        return meda._rcp(params.width), meda._rcp(params.length)
    if params.obs_version == "v0.2":
        return (meda._rcp(params.width / 30.0),
                meda._rcp(params.length / 30.0))
    return 0.0, 0.0


def kernel_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel; set its C signature."""
    lib = _build.build("meda_step").lib
    fn = lib.meda_step_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(params: meda.MEDAParams, state: meda.MEDAState,
           actions: torch.Tensor, uniforms: torch.Tensor):
    """Raise unless every tensor the kernel reads has its dtype, shape,
    device and a contiguous layout."""
    B = state.center.shape[0] if state.center.dim() == 3 else -1
    N, W, L = params.n_droplets, params.width, params.length
    if B < 1:
        raise ValueError(f"center must be (B, N, 2) with B >= 1, got "
                         f"{tuple(state.center.shape)}")
    expect = {
        "center": (state.center, torch.int32, (B, N, 2)),
        "dest": (state.dest, torch.int32, (B, N, 2)),
        "sq_dist": (state.sq_dist, torch.int32, (B, N)),
        "status": (state.status, torch.bool, (B, N)),
        "health": (state.health, torch.float32, (B, W, L)),
        "usage": (state.usage, torch.float32, (B, W, L)),
        "step_count": (state.step_count, torch.int32, (B,)),
        "fails_count": (state.fails_count, torch.int32, (B,)),
        "actions": (actions, torch.int32, (B, N)),
        "uniforms": (uniforms, torch.float32, (B, N)),
    }
    device = state.center.device
    check_tensors(expect, device, "center")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no meda_step kernel for device {device}")


def step_batch(params: meda.MEDAParams, state: meda.MEDAState,
               actions: torch.Tensor, uniforms: torch.Tensor):
    """One MEDA step of B chips (the transition and the observation of the
    new state): on CUDA the kernel, on the CPU the plain version.  Returns
    ``(new_state, StepOutput)``."""
    _check(params, state, actions, uniforms)
    device = state.center.device
    if device.type == "cpu":
        return meda.step_core(params, state, actions, uniforms)
    # the launch reads the current device's stream: the tensors' device,
    # whichever device the caller has made current
    with torch.cuda.device(device):
        return _launch(params, state, actions, uniforms,
                       torch.cuda.current_stream(device).cuda_stream)


def _launch(params: meda.MEDAParams, state: meda.MEDAState,
            actions: torch.Tensor, uniforms: torch.Tensor, stream: int):
    """Launch the kernel on ``stream`` (a ``cudaStream_t`` as an integer)
    over tensors that :func:`_check` passed; the outputs are allocated on
    the tensors' device.  ``health``, ``degrade``, ``start`` and ``dest``
    are returned as the same tensors."""
    global launches
    B, N = state.sq_dist.shape
    device = state.center.device
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                             device=device)
    center = empty((B, N, 2), torch.int32)
    sq_dist = empty((B, N), torch.int32)
    status = empty((B, N), torch.bool)
    usage = torch.empty_like(state.usage)
    step_count = empty((B,), torch.int32)
    fails_count = empty((B,), torch.int32)
    obs = empty((B, N, params.obs_dim), params.obs_dtype)
    rewards = empty((B, N), torch.float32)
    team = empty((B,), torch.float32)
    dones = empty((B, N), torch.bool)
    terminated = empty((B,), torch.bool)
    constraints = empty((B,), torch.int32)
    success = empty((B,), torch.int32)
    rc = kernel_library().meda_step_launch(*(t.data_ptr() for t in (
        state.center, state.sq_dist, state.dest, state.status, state.health,
        state.usage, state.step_count, state.fails_count, actions, uniforms,
        center, sq_dist, status, usage, step_count, fails_count, obs,
        rewards, team, dones, terminated, constraints, success)),
        B, params.width, params.length, N, params.fov, params.max_step,
        VERSIONS[params.obs_version], *direction_reciprocals(params), stream)
    if rc != 0:
        raise RuntimeError(
            f"meda_step kernel launch failed: CUDA error {rc}"
            + (f" (invalid value: {params.n_droplets} droplets and fov "
               f"{params.fov} in {params.obs_version} may not fit a block's "
               f"shared memory)" if rc == 1 else ""))
    launches += 1
    tracing.count("env.meda_step.chips", B)
    new_state = state._replace(center=center, sq_dist=sq_dist, status=status,
                               usage=usage, step_count=step_count,
                               fails_count=fails_count)
    out = meda.StepOutput(obs=obs, rewards=rewards, team_reward=team,
                          dones=dones, terminated=terminated,
                          constraints=constraints, success=success)
    return new_state, out
