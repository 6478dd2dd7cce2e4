"""Wrapper of the fused DMFB step kernel (``csrc/dmfb_step.cu``).

Replaces the Pallas TPU kernel of ``marl_dmfb_tpu/ops/dmfb_step_pallas.py``
(``_make_kernel``, :44-219, through ``pallas_step_batch``).  Unlike the JAX
package, where the XLA step was the production path and the Pallas kernel a
reference, the port takes this kernel as its production env step.

:func:`step_batch` takes a batched :class:`DMFBState`, actions and
move-success draws, and returns what ``envs.dmfb.step_core`` returns.  On
CPU tensors it runs that plain version; on CUDA tensors it launches the
kernel (built on first use) or raises.  The kernel computes the v0
observation; for the v0.1 observation it runs in its no-observation mode
(the transition alone, :func:`transition_batch`, whose plain version is
``envs.dmfb.transition``), and the plain v0.1 ``observe`` follows on the
new state, as the JAX package observes after ``step_core``.  ``launches``
counts kernel launches in either mode, ``launches_no_obs`` those in the
no-observation mode.
"""

from __future__ import annotations

import ctypes

import torch

from marl_dmfb_tpu_torch.envs import dmfb
from marl_dmfb_tpu_torch.ops import _build

launches = 0         # kernel launches since import (reset by callers
launches_no_obs = 0  # that count); of them, no-observation launches

MAX_DROPLETS = 16  # the kernel's compile-time bound (kMaxDroplets)
SMEM_LIMIT = 227 * 1024   # a block's dynamic shared memory on sm_90 (kSmemLimit)
MAX_TILE = 16      # chips per tile at most (kMaxTile)
FILL_TILES = 264   # tiles that give each of an H100's 132 SMs two

_ARGTYPES = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _obs_row(params: dmfb.DMFBParams, observe: bool) -> int:
    """Bytes of one droplet's observation that the kernel writes: the v0
    row (3*fov*fov + 2 int8), or none in the no-observation mode."""
    return 3 * params.fov * params.fov + 2 if observe else 0


def _span_bytes(params: dmfb.DMFBParams, observe: bool = True) -> list:
    """Bytes per chip of each span of one tile buffer in the kernel's shared
    memory, in the order of ``layout`` in ``csrc/dmfb_step.cu``: the staged
    inputs (pos, goal, dist, actions, uniforms, step_count,
    cum_constraints, block_mask, usage), the observations (none in the
    no-observation mode), the new positions and a flag."""
    n, wl = params.n_droplets, params.width * params.length
    return [8 * n, 8 * n, 4 * n, 4 * n, 4 * n, 4, 4, wl, 4 * wl,
            n * _obs_row(params, observe), 8 * n, 1]


def tile_bytes(params: dmfb.DMFBParams, tile: int,
               observe: bool = True) -> int:
    """Dynamic shared memory of a block whose tiles hold ``tile`` chips: 16
    bytes of mbarriers, then two tile buffers, each span rounded up to 16
    bytes."""
    return 16 + 2 * sum(-(-tile * b // 16) * 16
                        for b in _span_bytes(params, observe))


def tile_chips(params: dmfb.DMFBParams, batch: int,
               observe: bool = True) -> int:
    """Chips per block for a launch over ``batch`` chips.

    A tile takes bulk copies only where its spans start on 16-byte
    boundaries, so it is a multiple of the least count of chips that makes
    every staged span and the observation span a multiple of 16 bytes (4 on
    a 10x10 board with 4 droplets).  Of those counts that fit in shared
    memory, it is the largest that still gives ``FILL_TILES`` tiles, else
    the smallest, so that a small batch spreads over more SMs.  Raises
    ``ValueError`` where not even one chip fits."""
    fits = [c for c in range(1, MAX_TILE + 1)
            if tile_bytes(params, c, observe) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"one chip of a {params.width}x{params.length} board with "
            f"{params.n_droplets} droplets and fov {params.fov} needs "
            f"{tile_bytes(params, 1, observe)} bytes of shared memory; the "
            f"kernel has {SMEM_LIMIT}")
    staged = _span_bytes(params, observe)[:10]
    step = next(g for g in (1, 2, 4, 8, 16)
                if all(g * b % 16 == 0 for b in staged))
    aligned = [c for c in fits if c % step == 0]
    if not aligned:
        return fits[-1]
    filling = [c for c in aligned if -(-batch // c) >= FILL_TILES]
    return filling[-1] if filling else aligned[0]


def min_bytes(params: dmfb.DMFBParams, batch: int,
              observe: bool = True) -> int:
    """Least bytes one step of ``batch`` chips must move through device
    memory: every input read once and every output written once (the v0
    observations only with ``observe``), except the health board, which the
    step reads only under the N droplets, one 32-byte sector each."""
    n, wl = params.n_droplets, params.width * params.length
    read = (8 * n + 4 * n + 8 * n          # pos, dist, goal
            + 4 * wl + wl                  # usage, block_mask
            + 4 * n + 4 * n + 4 + 4        # actions, uniforms, counters
            + min(4 * wl, 32 * n))         # health under the droplets
    write = (8 * n + 4 * n + 4 * wl + 4 + 4       # the new state
             + n * _obs_row(params, observe)      # obs
             + 4 * n + n                          # rewards, dones
             + 4 + 1 + 4 + 4)                     # team, terminated,
    return batch * (read + write)                 # constraints, success


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


def _on_card(params: dmfb.DMFBParams, state: dmfb.DMFBState,
             actions: torch.Tensor, uniforms: torch.Tensor) -> bool:
    """Check the inputs; True where they are on a card (launch), False on
    the CPU (plain version)."""
    _check(params, state, actions, uniforms)
    device = state.pos.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no dmfb_step kernel for device {device}")
    return device.type == "cuda"


def step_batch(params: dmfb.DMFBParams, state: dmfb.DMFBState,
               actions: torch.Tensor, uniforms: torch.Tensor):
    """One DMFB step of B chips (transition and observation): the kernel on
    CUDA, the plain version on the CPU.  Returns ``(new_state,
    StepOutput)``."""
    v0 = params.obs_version == "v0"
    if not _on_card(params, state, actions, uniforms):
        return dmfb.step_core(params, state, actions, uniforms)
    # the launch sets the shared-memory attribute and reads the SM count of
    # the current device, and takes the current stream: all must be the
    # tensors' device, whichever device the caller has made current
    with torch.cuda.device(state.pos.device):
        if v0:
            return _launch(params, state, actions, uniforms, True)
        new_state, out = _launch(params, state, actions, uniforms, False)
        return new_state, out._replace(obs=dmfb.observe(params, new_state))


def transition_batch(params: dmfb.DMFBParams, state: dmfb.DMFBState,
                     actions: torch.Tensor, uniforms: torch.Tensor):
    """The transition alone (``StepOutput.obs`` is None): the kernel's
    no-observation mode on CUDA, ``envs.dmfb.transition`` on the CPU."""
    if not _on_card(params, state, actions, uniforms):
        return dmfb.transition(params, state, actions, uniforms)
    with torch.cuda.device(state.pos.device):
        return _launch(params, state, actions, uniforms, False)


def _launch(params: dmfb.DMFBParams, state: dmfb.DMFBState,
            actions: torch.Tensor, uniforms: torch.Tensor, observe: bool):
    """Launch the kernel on the current device, which holds the tensors;
    without ``observe`` it writes no observations (``obs`` is None)."""
    global launches, launches_no_obs
    device = state.pos.device
    B, N = state.dist.shape
    tile = tile_chips(params, B, observe)
    fn = kernel_library().dmfb_step_launch
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                             device=device)
    pos = empty((B, N, 2), torch.int32)
    dist = empty((B, N), torch.int32)
    usage = torch.empty_like(state.usage)
    step_count = empty((B,), torch.int32)
    cum_constraints = empty((B,), torch.int32)
    rewards = empty((B, N), torch.float32)
    obs = (empty((B, N, _obs_row(params, True)), torch.int8) if observe
           else None)
    dones = empty((B, N), torch.bool)
    terminated = empty((B,), torch.bool)
    constraints = empty((B,), torch.int32)
    success = empty((B,), torch.int32)
    team = empty((B,), torch.float32)
    rcp_x, rcp_y = params.zoom_reciprocals()
    ptr = lambda t: 0 if t is None else t.data_ptr()
    rc = fn(
        ptr(state.pos), ptr(state.dist), ptr(state.goal), ptr(state.health),
        ptr(state.usage), ptr(state.block_mask), ptr(actions), ptr(uniforms),
        ptr(state.step_count), ptr(state.cum_constraints),
        ptr(pos), ptr(dist), ptr(usage), ptr(step_count),
        ptr(cum_constraints), ptr(rewards), ptr(obs), ptr(dones),
        ptr(terminated), ptr(constraints), ptr(success), ptr(team),
        B, params.width, params.length, N, params.fov, int(params.stall),
        params.max_step, tile, int(observe), rcp_x, rcp_y,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dmfb_step kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_no_obs += not observe
    new_state = state._replace(pos=pos, dist=dist, usage=usage,
                               step_count=step_count,
                               cum_constraints=cum_constraints)
    out = dmfb.StepOutput(obs=obs, rewards=rewards, team_reward=team,
                          dones=dones, terminated=terminated,
                          constraints=constraints, success=success)
    return new_state, out
