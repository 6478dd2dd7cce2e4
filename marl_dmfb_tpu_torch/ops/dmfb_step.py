"""Wrapper of the fused DMFB step kernels (``csrc/dmfb_step.cu`` and
``csrc/dmfb_step_wide.cu``).

Replaces the Pallas TPU kernel of ``marl_dmfb_tpu/ops/dmfb_step_pallas.py``
(``_make_kernel``, :44-219, through ``pallas_step_batch``).  Unlike the JAX
package, where the XLA step was the production path and the Pallas kernel a
reference, the port takes these kernels as its production env step.

:func:`step_batch` takes a batched :class:`DMFBState`, actions and
move-success draws, and returns what ``envs.dmfb.step_core`` returns.  On
CPU tensors it runs that plain version; on CUDA tensors it launches a
kernel (built on first use) or raises.  Two hand kernels compute the step,
chosen by shape (:func:`kernel_for`): the tile kernel, which stages tiles
of up to 16 chips in shared memory, for at most ``MAX_DROPLETS`` droplets
and a chip that fits there (every shipped configuration); the wide kernel
for everything else that ``DMFBParams`` accepts, in one of two layouts
(:func:`wide_group_chips`): groups of chips staged in shared memory, or one
block per chip for the large boards whose usage board is the cost.  Both
compute the v0 observation; for the v0.1 observation they run in their
no-observation mode (the transition alone, :func:`transition_batch`, whose
plain version is ``envs.dmfb.transition``), and the plain v0.1 ``observe``
follows on the new state, as the JAX package observes after ``step_core``.
``launches`` counts the tile kernel's launches in either mode,
``launches_no_obs`` those in its no-observation mode, ``launches_wide``
the wide kernel's launches in either mode.
"""

from __future__ import annotations

import ctypes

import torch

from marl_dmfb_tpu_torch.envs import dmfb
from marl_dmfb_tpu_torch.ops import _build, check_tensors

launches = 0         # tile kernel launches since import (reset by callers
launches_no_obs = 0  # that count); of them, no-observation launches
launches_wide = 0    # wide kernel launches since import

MAX_DROPLETS = 16  # the tile kernel's compile-time bound (kMaxDroplets)
SMEM_LIMIT = 227 * 1024   # a block's dynamic shared memory on sm_90 (kSmemLimit)
MAX_TILE = 16      # chips per tile at most (kMaxTile)
FILL_TILES = 264   # tiles that give each of an H100's 132 SMs two
# the wide kernel's group layout: threads of a block (kThreads), chips of a
# group at most (kMaxGroup); an H100 SM's shared memory, of which each block
# takes 1 KB more than it asks for
GROUP_THREADS = 128
MAX_GROUP = 32
SM_SMEM = 228 * 1024
# its chip layout: the workspace in shared memory at most (kWideSmemLimit;
# a larger one goes to a global scratch buffer), the observation rows it
# stages at a time (kRowBytes), and its blocks on one SM at most (2048
# threads over a block of 128; a scratch buffer holds a workspace for each
# block of the grid)
WIDE_SMEM_LIMIT = 227 * 1024 - 1024
WIDE_ROW_BYTES = 8192
WIDE_BLOCKS_PER_SM = 16

_ARGTYPES = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_WIDE_ARGTYPES = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 10 + [
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


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def tile_bytes(params: dmfb.DMFBParams, tile: int,
               observe: bool = True) -> int:
    """Dynamic shared memory of a block whose tiles hold ``tile`` chips: 16
    bytes of mbarriers, then two tile buffers, each span rounded up to 16
    bytes."""
    return 16 + 2 * sum(_round16(tile * b) for b in _span_bytes(params, observe))


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
    observations only with ``observe``), except the health board and the
    block mask.  The step reads health only under the N droplets, one
    32-byte sector each, and the block mask only under their N candidate
    cells and, with ``observe``, in the fov rows of its [0, fov)^2 corner,
    one sector each; neither is written."""
    n, wl = params.n_droplets, params.width * params.length
    corner = params.fov if observe else 0
    read = (8 * n + 4 * n + 8 * n          # pos, dist, goal
            + 4 * wl                       # usage
            + 4 * n + 4 * n + 4 + 4        # actions, uniforms, counters
            + min(4 * wl, 32 * n)          # health under the droplets
            + min(wl, 32 * (n + corner)))  # block_mask, as it is read
    write = (8 * n + 4 * n + 4 * wl + 4 + 4       # the new state
             + n * _obs_row(params, observe)      # obs
             + 4 * n + n                          # rewards, dones
             + 4 + 1 + 4 + 4)                     # team, terminated,
    return batch * (read + write)                 # constraints, success


def kernel_for(params: dmfb.DMFBParams, observe: bool = True) -> str:
    """The kernel that steps ``params`` on the card: ``"tile"`` for at most
    ``MAX_DROPLETS`` droplets and a chip whose tile fits in shared memory,
    else ``"wide"``.  The batch does not enter: the tile kernel takes any
    batch where it takes one chip."""
    if (params.n_droplets <= MAX_DROPLETS
            and tile_bytes(params, 1, observe) <= SMEM_LIMIT):
        return "tile"
    return "wide"


def _group_spans(params: dmfb.DMFBParams, chips: int,
                 observe: bool = True) -> tuple:
    """(inputs, work): bytes of each span of a group of ``chips`` chips in
    the wide kernel's group layout, in the order of ``group_layout`` in
    ``csrc/dmfb_step_wide.cu``.  The inputs (pos, goal, dist, actions,
    uniforms, step_count, cum_constraints, block_mask, usage) fill each of
    two buffers; the work area
    holds two occupancy maps a chip (of the past and the new cells, padded
    by a cell on each side), the past and new cells and the goal, distance
    and flags of each droplet and the map indices of its move and its past
    cell (int4 each),
    the health under each droplet (fetched a group ahead), the rewards, per
    chip two sums and its step and, with ``observe``, the block corner's
    fov^2 bits and the observation rows (16 bytes spare, to match their
    offset in device memory)."""
    c, n, wl = chips, params.n_droplets, params.width * params.length
    inputs = [8 * c * n, 8 * c * n, 4 * c * n, 4 * c * n, 4 * c * n, 4 * c,
              4 * c, c * wl, 4 * c * wl]
    maps = 2 * c * (params.width + 2) * (params.length + 2)
    work = [maps, 16 * c * n, 16 * c * n, 16 * c * n, 4 * c * n, 4 * c * n,
            16 * c]
    if observe:
        corner = 4 * c * -(-params.fov ** 2 // 32)
        return inputs, work + [corner, c * n * _obs_row(params, True) + 16]
    return inputs, work + [0, 0]


def group_bytes(params: dmfb.DMFBParams, chips: int,
                observe: bool = True) -> int:
    """Dynamic shared memory of a group-layout block of ``chips`` chips: 32
    bytes of mbarriers, two input buffers (each staged span takes 16 bytes
    more than its size rounded up to 16, since it arrives as the 16-byte
    words that cover it in device memory) and the work area."""
    inputs, work = _group_spans(params, chips, observe)
    return (32 + 2 * sum(_round16(b + 16) for b in inputs)
            + sum(_round16(b) for b in work))


def _blocks_per_sm(nbytes: int) -> int:
    """Blocks of ``nbytes`` of dynamic shared memory that share an SM."""
    return SM_SMEM // (nbytes + 1024)


def wide_group_chips(params: dmfb.DMFBParams, batch: int,
                     observe: bool = True) -> int:
    """Chips a group of the wide kernel for a launch over ``batch`` chips,
    or 0 for its chip layout (one block per chip) where a group of one chip
    leaves no room for a second block on the SM: there a block would wait
    alone on its bulk copies, and the chip layout is the faster (PERF.md).

    At most one chip a lane of warp 0 (``MAX_GROUP``) and as many as give
    each of the block's ``GROUP_THREADS`` threads a (chip, droplet) pair;
    of those counts whose blocks still share an SM two at a time, the
    largest that still gives ``FILL_TILES`` groups, else the smallest, so
    that a small batch spreads over more SMs."""
    if _blocks_per_sm(group_bytes(params, 1, observe)) < 2:
        return 0
    most = max(1, min(MAX_GROUP, GROUP_THREADS // params.n_droplets, batch))
    fits = [c for c in range(1, most + 1)
            if _blocks_per_sm(group_bytes(params, c, observe)) >= 2]
    filling = [c for c in fits if -(-batch // c) >= FILL_TILES]
    return filling[-1] if filling else fits[0]


def wide_rows(params: dmfb.DMFBParams) -> int:
    """Observation rows the wide kernel's chip layout stages at a time
    (``chunk_rows``): as many as fit in ``WIDE_ROW_BYTES``, at least
    one."""
    return min(params.n_droplets,
               max(1, WIDE_ROW_BYTES // _obs_row(params, True)))


def _wide_spans(params: dmfb.DMFBParams, observe: bool = True) -> list:
    """Bytes of each span of one chip's workspace in the wide kernel's chip
    layout, in the order of ``workspace`` in ``csrc/dmfb_step_wide.cu``: the
    occupancy
    count map, the past and new cells, the goals, the candidate cells, the
    past and new distances, the flags, the rewards, the usage at the past
    and candidate cells, and with ``observe`` the block mask's corner
    [0, fov)^2 and the staged observation rows (16 bytes spare, to match
    their alignment in device memory)."""
    n, f2 = params.n_droplets, params.fov * params.fov
    rows = wide_rows(params) * _obs_row(params, True) + 16
    return [params.width * params.length, 8 * n, 8 * n, 8 * n, 8 * n,
            4 * n, 4 * n, n, 4 * n, 8 * n] + ([f2, rows] if observe
                                              else [0, 0])


def wide_workspace_bytes(params: dmfb.DMFBParams,
                         observe: bool = True) -> int:
    """One chip's workspace in the wide kernel's chip layout, each span
    rounded up to 16 bytes: dynamic shared memory up to
    ``WIDE_SMEM_LIMIT``, else a slice of the global scratch buffer."""
    return sum(_round16(b) for b in _wide_spans(params, observe))


def _library(name: str, launch: str, argtypes: list) -> ctypes.CDLL:
    lib = _build.build(name).lib
    fn = getattr(lib, launch)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """Build (if needed) and load the tile kernel; set its C signature."""
    return _library("dmfb_step", "dmfb_step_launch", _ARGTYPES)


def wide_library() -> ctypes.CDLL:
    """Build (if needed) and load the wide kernel; set its C signature."""
    return _library("dmfb_step_wide", "dmfb_step_wide_launch",
                    _WIDE_ARGTYPES)


def _check(params: dmfb.DMFBParams, state: dmfb.DMFBState,
           actions: torch.Tensor, uniforms: torch.Tensor):
    """Raise unless every tensor has the kernels' dtype, shape, device and a
    contiguous layout."""
    B = state.pos.shape[0] if state.pos.dim() == 3 else -1
    N, W, L = params.n_droplets, params.width, params.length
    if B < 1:
        raise ValueError(f"pos must be (B, N, 2) with B >= 1, got "
                         f"{tuple(state.pos.shape)}")
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
    check_tensors(expect, state.pos.device, "pos")


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
    """One DMFB step of B chips (transition and observation): on CUDA the
    kernel that :func:`kernel_for` names, on the CPU the plain version.
    Returns ``(new_state, StepOutput)``."""
    v0 = params.obs_version == "v0"
    if not _on_card(params, state, actions, uniforms):
        return dmfb.step_core(params, state, actions, uniforms)
    # the launch sets the shared-memory attribute and reads the SM count of
    # the current device, and takes the current stream: all must be the
    # tensors' device, whichever device the caller has made current
    with torch.cuda.device(state.pos.device):
        if v0:
            return _launch(params, state, actions, uniforms, True,
                           kernel_for(params, True))
        new_state, out = _launch(params, state, actions, uniforms, False,
                                 kernel_for(params, False))
        return new_state, out._replace(obs=dmfb.observe(params, new_state))


def transition_batch(params: dmfb.DMFBParams, state: dmfb.DMFBState,
                     actions: torch.Tensor, uniforms: torch.Tensor):
    """The transition alone (``StepOutput.obs`` is None): the
    no-observation mode of the kernel that :func:`kernel_for` names on CUDA,
    ``envs.dmfb.transition`` on the CPU."""
    if not _on_card(params, state, actions, uniforms):
        return dmfb.transition(params, state, actions, uniforms)
    with torch.cuda.device(state.pos.device):
        return _launch(params, state, actions, uniforms, False,
                       kernel_for(params, False))


def _launch(params: dmfb.DMFBParams, state: dmfb.DMFBState,
            actions: torch.Tensor, uniforms: torch.Tensor, observe: bool,
            kernel: str):
    """Launch ``kernel`` (``"tile"`` or ``"wide"``) on the current device,
    which holds the tensors; without ``observe`` it writes no observations
    (``obs`` is None)."""
    global launches, launches_no_obs, launches_wide
    if kernel not in ("tile", "wide"):
        raise ValueError(f"no dmfb_step kernel {kernel!r}")
    device = state.pos.device
    B, N = state.dist.shape
    wide = kernel == "wide"
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
    tensors = [ptr(t) for t in (
        state.pos, state.dist, state.goal, state.health, state.usage,
        state.block_mask, actions, uniforms, state.step_count,
        state.cum_constraints, pos, dist, usage, step_count, cum_constraints,
        rewards, obs, dones, terminated, constraints, success, team)]
    sizes = [B, params.width, params.length, N, params.fov,
             int(params.stall), params.max_step]
    stream = torch.cuda.current_stream(device).cuda_stream
    if wide:
        group = wide_group_chips(params, B, observe)
        scratch, slots = None, 0
        if not group and wide_workspace_bytes(params, observe) \
                > WIDE_SMEM_LIMIT:
            slots = min(B, WIDE_BLOCKS_PER_SM * torch.cuda.get_device_properties(
                device).multi_processor_count)
            scratch = empty((slots, wide_workspace_bytes(params, observe)),
                            torch.uint8)
        rc = wide_library().dmfb_step_wide_launch(
            *tensors, ptr(scratch), slots, *sizes, group, int(observe),
            rcp_x, rcp_y, stream)
    else:
        rc = kernel_library().dmfb_step_launch(
            *tensors, *sizes, tile_chips(params, B, observe), int(observe),
            rcp_x, rcp_y, stream)
    if rc != 0:
        raise RuntimeError(f"dmfb_step{'_wide' * wide} kernel launch "
                           f"failed: CUDA error {rc}")
    if wide:
        launches_wide += 1
    else:
        launches += 1
        launches_no_obs += not observe
    new_state = state._replace(pos=pos, dist=dist, usage=usage,
                               step_count=step_count,
                               cum_constraints=cum_constraints)
    out = dmfb.StepOutput(obs=obs, rewards=rewards, team_reward=team,
                          dones=dones, terminated=terminated,
                          constraints=constraints, success=success)
    return new_state, out
