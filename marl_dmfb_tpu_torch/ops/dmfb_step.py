"""Wrapper of the fused DMFB step kernel (``csrc/dmfb_step.cu``).

Replaces the Pallas TPU kernel of ``marl_dmfb_tpu/ops/dmfb_step_pallas.py``
(``_make_kernel``, :44-219, through ``pallas_step_batch``).  Unlike the JAX
package, where the XLA step was the production path and the Pallas kernel a
reference, the port takes this kernel as its production env step.

:func:`step_batch` takes a batched :class:`DMFBState`, actions and
move-success draws, and returns what ``envs.dmfb.step_core`` returns.  On
CPU tensors it runs that plain version; on CUDA tensors it launches the
kernel (built on first use) or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from marl_dmfb_tpu_torch.envs import dmfb
from marl_dmfb_tpu_torch.ops import _build

launches = 0   # kernel launches since import (reset by callers that count)

MAX_DROPLETS = 16  # the kernel's compile-time bound (kMaxDroplets)

_ARGTYPES = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def kernel_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel; set its C signature."""
    lib = _build.build("dmfb_step").lib
    fn = lib.dmfb_step_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(params: dmfb.DMFBParams, state: dmfb.DMFBState,
           actions: torch.Tensor, uniforms: torch.Tensor):
    """Raise unless every tensor has the kernel's dtype, shape, device and a
    contiguous layout."""
    B = state.pos.shape[0] if state.pos.dim() == 3 else -1
    N, W, L = params.n_droplets, params.width, params.length
    if B < 1:
        raise ValueError(f"pos must be (B, N, 2) with B >= 1, got "
                         f"{tuple(state.pos.shape)}")
    if N > MAX_DROPLETS:
        raise ValueError(f"the kernel takes at most {MAX_DROPLETS} droplets, "
                         f"got {N}")
    expect = {
        "pos": (state.pos, torch.int32, (B, N, 2)),
        "goal": (state.goal, torch.int32, (B, N, 2)),
        "dist": (state.dist, torch.int32, (B, N)),
        "health": (state.health, torch.float32, (B, W, L)),
        "usage": (state.usage, torch.float32, (B, W, L)),
        "block_mask": (state.block_mask, torch.bool, (B, W, L)),
        "step_count": (state.step_count, torch.int32, (B,)),
        "cum_constraints": (state.cum_constraints, torch.int32, (B,)),
        "actions": (actions, torch.int32, (B, N)),
        "uniforms": (uniforms, torch.float32, (B, N)),
    }
    device = state.pos.device
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, pos on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def step_batch(params: dmfb.DMFBParams, state: dmfb.DMFBState,
               actions: torch.Tensor, uniforms: torch.Tensor):
    """One DMFB transition of B chips: the kernel on CUDA, the plain version
    on the CPU.  Returns ``(new_state, StepOutput)``."""
    global launches
    _check(params, state, actions, uniforms)
    device = state.pos.device
    if device.type == "cpu":
        return dmfb.step_core(params, state, actions, uniforms)
    if device.type != "cuda":
        raise ValueError(f"no dmfb_step kernel for device {device}")
    fn = kernel_library().dmfb_step_launch
    B, N = state.dist.shape
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                             device=device)
    pos = empty((B, N, 2), torch.int32)
    dist = empty((B, N), torch.int32)
    usage = torch.empty_like(state.usage)
    step_count = empty((B,), torch.int32)
    cum_constraints = empty((B,), torch.int32)
    rewards = empty((B, N), torch.float32)
    obs = empty((B, N, params.obs_dim), torch.int8)
    dones = empty((B, N), torch.bool)
    terminated = empty((B,), torch.bool)
    constraints = empty((B,), torch.int32)
    success = empty((B,), torch.int32)
    team = empty((B,), torch.float32)
    rcp_x, rcp_y = params.zoom_reciprocals()
    ptr = lambda t: t.data_ptr()
    rc = fn(
        ptr(state.pos), ptr(state.dist), ptr(state.goal), ptr(state.health),
        ptr(state.usage), ptr(state.block_mask), ptr(actions), ptr(uniforms),
        ptr(state.step_count), ptr(state.cum_constraints),
        ptr(pos), ptr(dist), ptr(usage), ptr(step_count),
        ptr(cum_constraints), ptr(rewards), ptr(obs), ptr(dones),
        ptr(terminated), ptr(constraints), ptr(success), ptr(team),
        B, params.width, params.length, N, params.fov, int(params.stall),
        params.max_step, rcp_x, rcp_y,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dmfb_step kernel launch failed: CUDA error {rc}")
    launches += 1
    new_state = state._replace(pos=pos, dist=dist, usage=usage,
                               step_count=step_count,
                               cum_constraints=cum_constraints)
    out = dmfb.StepOutput(obs=obs, rewards=rewards, team_reward=team,
                          dones=dones, terminated=terminated,
                          constraints=constraints, success=success)
    return new_state, out
