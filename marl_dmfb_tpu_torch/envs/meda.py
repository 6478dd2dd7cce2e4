"""MEDA micro-electrode-dot-array environment in PyTorch, batched over B
chips (JAX ``marl_dmfb_tpu/envs/meda.py``).

The semantics are the JAX package's (reference ``env/MEDA/meda.py``):

* droplets are 5x5-cell bodies (radius 2) that move 3 cells straight or
  2 cells diagonally a step; 9 actions: N, E, S, W, NE, SE, SW, NW, STALL;
* there is no collision revert: each too-close pair of droplets costs
  -0.6 to both, and the count of such pairs accumulates in ``fails_count``;
* a droplet within 4 cells of its destination snaps onto it and its
  ``status`` latches;
* a move succeeds with the mean electrode health under the footprint;
* the health and usage boards are indexed ``[y][x]``, shape
  ``(width, length)``; ``center[b, i] = (x, y)``.

Every distance test is a threshold on squared integer distances, as in the
JAX package.  A droplet's move reads only its own center, distance, status
and destination and the health board, which the step does not change, so
the JAX package's per-droplet loop is order-free and :func:`_move_droplets`
moves all chips and droplets at once.

The JAX package has no Pallas kernel for MEDA: XLA compiled its plain code.
:func:`step_core` here is the plain PyTorch version of the port's MEDA step:
the env registry (``envs/registry.py``) steps through
``ops/meda_step.step_batch``, which runs this version on CPU tensors and
the hand CUDA kernel ``csrc/meda_step.cu`` on CUDA tensors, and the tests
hold the kernel to this version.  Task generation takes an explicit
``torch.Generator`` (its numbers differ from a JAX key's), and
:func:`step_core` takes the move-success draws as an argument so that tests
can replay the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from marl_dmfb_tpu_torch.envs.dmfb import StepOutput

N_ACTIONS = 9
STALL = 8
RADIUS = 2
FOOTPRINT = 2 * RADIUS + 1          # 5x5 cells

# (dx, dy) per action: N, E, S, W step 3, diagonals 2, STALL none
ACTION_DELTAS = (
    (0, -3), (3, 0), (0, 3), (-3, 0), (2, -2), (2, 2), (-2, 2), (-2, -2),
    (0, 0),
)
SQ_GOAL = (2 * RADIUS) ** 2                       # snap when sq_dist < 16
SQ_PUNISH = int((1.5 * 2 * RADIUS) ** 2)          # punish when < 36
SQ_TOO_CLOSE = int((1.5 * (2 * RADIUS + 2)) ** 2)  # task spacing: 81
GEN_ROUNDS = 32          # candidate centers per droplet in task generation
OBS_VERSIONS = ("v0", "v0.1", "v0.2")


@dataclasses.dataclass(frozen=True)
class MEDAParams:
    """Static environment configuration (JAX meda.py:64-128)."""

    width: int = 30    # y extent (rows)
    length: int = 60   # x extent (cols)
    n_droplets: int = 4
    fov: int = 19
    stall: bool = True           # unused by the MEDA dynamics
    b_degrade: bool = False
    per_degrade: float = 0.1
    obs_version: str = "v0"      # "v0", "v0.1" (4 float32 layers), "v0.2"

    def __post_init__(self):
        if self.obs_version not in OBS_VERSIONS:
            raise ValueError(f"unknown MEDA observation {self.obs_version!r}")
        if self.n_droplets > int(self.width / 15) * int(self.length / 15):
            raise RuntimeError(
                "Too many droplets in the %dx%d MEDA array"
                % (self.width, self.length))
        if self.fov % 2 != 1:
            raise ValueError("fov must be odd")

    @property
    def max_step(self) -> int:
        return self.width + self.length

    @property
    def episode_limit(self) -> int:
        return self.max_step

    @property
    def n_layers(self) -> int:
        return 3 if self.obs_version == "v0.2" else 4

    @property
    def obs_dim(self) -> int:
        return self.n_layers * self.fov * self.fov + 2

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        # (channels, fov, fov, vector length, flattened size), as DMFB's
        return (self.n_layers, self.fov, self.fov, 2, self.obs_dim)

    @property
    def state_dim(self) -> int:
        return 2 * self.width * self.length

    @property
    def obs_dtype(self) -> torch.dtype:
        return torch.int8 if self.obs_version == "v0.2" else torch.float32

    def env_info(self) -> dict:
        return {
            "n_actions": N_ACTIONS,
            "n_agents": self.n_droplets,
            "obs_shape": self.obs_shape,
            "state_shape": self.state_dim,
            "episode_limit": self.episode_limit,
        }


class MEDAState(NamedTuple):
    """Dynamic state of B chips; the JAX state's PRNG ``key`` is replaced by
    the caller's ``torch.Generator``."""

    center: torch.Tensor       # (B, N, 2) int32 — body center (x, y)
    start: torch.Tensor        # (B, N, 2) int32
    dest: torch.Tensor         # (B, N, 2) int32
    sq_dist: torch.Tensor      # (B, N) int32 — squared distance to dest
    status: torch.Tensor       # (B, N) bool — latched "on the goal"
    health: torch.Tensor       # (B, W, L) f32, [y][x]
    usage: torch.Tensor        # (B, W, L) f32
    degrade: torch.Tensor      # (B, W, L) f32
    step_count: torch.Tensor   # (B,) int32
    fails_count: torch.Tensor  # (B,) int32 — too-close incidences so far


# ---------------------------------------------------------------------------
# Task generation (JAX meda.py:152-248)
# ---------------------------------------------------------------------------


def _sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return (d * d).sum(dim=-1, dtype=torch.int32)


def fallback_lattice(params: MEDAParams) -> np.ndarray:
    """(N, 2) centers on a spacing-9 lattice, the placement where every
    candidate of a droplet is invalid."""
    xs = np.arange(RADIUS, params.length - RADIUS, 9)
    ys = np.arange(RADIUS, params.width - RADIUS, 9)
    grid = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    return grid[: params.n_droplets].astype(np.int32)


def _candidates(params: MEDAParams, batch: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """(B, R, 2) legal body centers: x in [2, L-3], y in [2, W-3]."""
    shape = (batch, GEN_ROUNDS)
    x = torch.randint(RADIUS, params.length - RADIUS, shape,
                      generator=generator, device=device, dtype=torch.int32)
    y = torch.randint(RADIUS, params.width - RADIUS, shape,
                      generator=generator, device=device, dtype=torch.int32)
    return torch.stack([x, y], dim=-1)


def _first_valid(cand: torch.Tensor, valid: torch.Tensor,
                 fallback: torch.Tensor) -> torch.Tensor:
    """The first valid candidate of each chip, else ``fallback``."""
    first = valid.to(torch.uint8).argmax(dim=1)
    pick = cand[torch.arange(cand.shape[0], device=cand.device), first]
    return torch.where(valid.any(dim=1)[:, None], pick, fallback)


def _gen_points(params: MEDAParams, batch: int, generator: torch.Generator,
                device, lattice: np.ndarray, avoid=None) -> torch.Tensor:
    """N points per chip, each the first of ``GEN_ROUNDS`` candidates whose
    squared distance to every earlier point is at least 81 and, given
    ``avoid`` (B, N, 2), whose body does not overlap point i of ``avoid``."""
    n = params.n_droplets
    lat = torch.as_tensor(np.ascontiguousarray(lattice), device=device)
    pts = torch.zeros((batch, n, 2), dtype=torch.int32, device=device)
    for i in range(n):
        cand = _candidates(params, batch, generator, device)      # (B, R, 2)
        d = cand[:, :, None, :] - pts[:, None, :i, :]
        ok = ((d * d).sum(dim=-1) >= SQ_TOO_CLOSE).all(dim=2)
        if avoid is not None:
            ok &= ~((cand - avoid[:, None, i]).abs() <= 2 * RADIUS).all(-1)
        pts[:, i] = _first_valid(cand, ok, lat[i])
    return pts


def _new_task(params: MEDAParams, batch: int, generator: torch.Generator,
              device):
    lattice = fallback_lattice(params)
    starts = _gen_points(params, batch, generator, device, lattice)
    dests = _gen_points(params, batch, generator, device, lattice[::-1],
                        avoid=starts)
    return starts, dests, _sq(starts, dests)


def random_degrade_map(params: MEDAParams, batch: int,
                       generator: torch.Generator, device) -> torch.Tensor:
    """Per-cell decay factors, as DMFB's (JAX meda.py:240-248)."""
    shape = (batch, params.width, params.length)
    if not params.b_degrade:
        return torch.ones(shape, dtype=torch.float32, device=device)
    m = torch.rand(shape, generator=generator, device=device) * 0.4 + 0.6
    sel = torch.rand(shape, generator=generator, device=device)
    return torch.where(sel < 1.0 - params.per_degrade, 1.0, m)


def init(params: MEDAParams, batch: int, generator: torch.Generator,
         device) -> MEDAState:
    """B fresh chips (JAX meda.py:251-268)."""
    device = torch.device(device)
    starts, dests, sq_dist = _new_task(params, batch, generator, device)
    shape = (batch, params.width, params.length)
    zeros_b = torch.zeros((batch,), dtype=torch.int32, device=device)
    return MEDAState(
        center=starts,
        start=starts,
        dest=dests,
        sq_dist=sq_dist,
        status=torch.zeros(sq_dist.shape, dtype=torch.bool, device=device),
        health=torch.ones(shape, dtype=torch.float32, device=device),
        usage=torch.zeros(shape, dtype=torch.float32, device=device),
        degrade=random_degrade_map(params, batch, generator, device),
        step_count=zeros_b,
        fails_count=zeros_b.clone(),
    )


def update_health(params: MEDAParams, state: MEDAState) -> MEDAState:
    """Decay cells used more than 50 times; a no-op unless ``b_degrade``
    (JAX meda.py:271-279)."""
    if not params.b_degrade:
        return state
    worn = state.usage > 50.0
    return state._replace(
        health=torch.where(worn, state.health * state.degrade, state.health),
        usage=torch.where(worn, 0.0, state.usage),
    )


def reset(params: MEDAParams, state: MEDAState,
          generator: torch.Generator) -> MEDAState:
    """New tasks; the wear persists and decays (JAX meda.py:282-298)."""
    batch, device = state.center.shape[0], state.center.device
    starts, dests, sq_dist = _new_task(params, batch, generator, device)
    zeros_b = torch.zeros((batch,), dtype=torch.int32, device=device)
    state = state._replace(
        center=starts, start=starts, dest=dests, sq_dist=sq_dist,
        status=torch.zeros_like(state.status), step_count=zeros_b,
        fails_count=zeros_b.clone(),
    )
    return update_health(params, state)


def restart(params: MEDAParams, state: MEDAState) -> MEDAState:
    """The same tasks from the start (JAX meda.py:301-309)."""
    zeros_b = torch.zeros_like(state.step_count)
    return state._replace(
        center=state.start,
        sq_dist=_sq(state.start, state.dest),
        status=torch.zeros_like(state.status),
        step_count=zeros_b,
        fails_count=zeros_b.clone(),
    )


# ---------------------------------------------------------------------------
# Step (JAX meda.py:324-473)
# ---------------------------------------------------------------------------


def footprint_mean_health(health: torch.Tensor,
                          center: torch.Tensor) -> torch.Tensor:
    """The mean health under each droplet's 5x5 footprint, (B, N) float32.

    The JAX package contracts one-hot bands with two float32 products and
    divides by 25, which XLA compiles to a sum down each column, then
    across, and a multiply by the float32 reciprocal of 25.  The window is
    summed here in that order with elementwise adds, so that the card, the
    CPU and jitted JAX give the same bits (the degradation sweep's health is
    below 1; training's is 1.0, where every order is exact)."""
    B, W, L = health.shape
    off = torch.arange(-RADIUS, RADIUS + 1, device=center.device)
    rows = (center[..., 1, None] + off).long()              # (B, N, 5)
    cols = (center[..., 0, None] + off).long()
    flat = health.reshape(B, 1, W * L)
    idx = rows[..., :, None] * L + cols[..., None, :]       # (B, N, 5, 5)
    win = flat.expand(B, center.shape[1], W * L).gather(
        2, idx.flatten(2)).view(idx.shape)
    col = win[..., 0, :]
    for r in range(1, FOOTPRINT):
        col = col + win[..., r, :]
    total = col[..., 0]
    for c in range(1, FOOTPRINT):
        total = total + col[..., c]
    return total * _rcp(FOOTPRINT * FOOTPRINT)


def _action_deltas(actions: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) moves of :data:`ACTION_DELTAS` by comparison, so that no
    table is copied to the device; an action outside [0, 9) moves nothing
    (JAX: a zero one-hot row)."""
    is_ = lambda *acts: sum((actions == k).int() for k in acts)
    dx = 3 * (is_(1) - is_(3)) + 2 * (is_(4, 5) - is_(6, 7))
    dy = 3 * (is_(2) - is_(0)) + 2 * (is_(5, 6) - is_(4, 7))
    return torch.stack([dx, dy], dim=-1)


def _move_droplets(params: MEDAParams, center, sq_dist, dest, status,
                   health, actions, uniforms):
    """All droplets of all chips at once (JAX meda.py:336-388): snap onto
    the destination when within reach, else move with probability the
    footprint's mean health, clipped to the board."""
    done = status
    snap = ~done & (sq_dist < SQ_GOAL)
    prob = footprint_mean_health(health, center)
    moved = ~done & ~snap & (uniforms <= prob)
    moved_to = center + _action_deltas(actions)
    cand = torch.stack([
        moved_to[..., 0].clamp(RADIUS, params.length - 1 - RADIUS),
        moved_to[..., 1].clamp(RADIUS, params.width - 1 - RADIUS)], dim=-1)
    new_c = torch.where(snap[..., None], dest,
                        torch.where(moved[..., None], cand, center))
    sq_new = _sq(new_c, dest)
    r = torch.where(
        sq_new < SQ_GOAL, 0.0,
        torch.where((sq_new == sq_dist) & (actions == STALL), -0.2,
                    torch.where(sq_new < sq_dist, -0.08, -0.4)))
    rewards = torch.where(done | snap, 0.0, r)
    sq_out = torch.where(done, sq_dist,
                         torch.where(snap, torch.zeros_like(sq_new), sq_new))
    center = torch.where(done[..., None], center, new_c)
    return center, sq_out, done | snap, rewards


def _punish(center: torch.Tensor):
    """-0.6 per too-close pair per droplet, and the count of too-close
    incidences per chip (JAX meda.py:391-401)."""
    n = center.shape[1]
    d = center[:, :, None, :] - center[:, None, :, :]
    close = (((d * d).sum(dim=-1) < SQ_PUNISH)
             & ~torch.eye(n, dtype=torch.bool, device=center.device))
    per_droplet = close.sum(dim=2, dtype=torch.int32)
    return -0.6 * per_droplet.float(), per_droplet.sum(dim=1,
                                                       dtype=torch.int32)


def _bands(params: MEDAParams, center: torch.Tensor):
    """(B, N, W) rows and (B, N, L) columns of each footprint, float32."""
    ys = torch.arange(params.width, device=center.device)
    xs = torch.arange(params.length, device=center.device)
    band_y = ((ys - center[..., 1, None]).abs() <= RADIUS).float()
    band_x = ((xs - center[..., 0, None]).abs() <= RADIUS).float()
    return band_y, band_x


def step_core(params: MEDAParams, state: MEDAState, actions: torch.Tensor,
              uniforms: torch.Tensor) -> Tuple[MEDAState, StepOutput]:
    """One step of B chips with injected move-success draws ``uniforms``
    (B, N): the transition, then the observation of the new state (JAX
    meda.py:404-466)."""
    actions = actions.to(torch.int32)
    center, sq_dist, status, rewards = _move_droplets(
        params, state.center, state.sq_dist, state.dest, state.status,
        state.health, actions, uniforms)
    punish, n_close = _punish(center)
    rewards = rewards + punish
    fails_count = state.fails_count + n_close
    all_done = status.all(dim=1)
    bonus = torch.where(all_done,
                        torch.where(fails_count == 0, 6.0, 3.0), 0.0)
    rewards = rewards + bonus[:, None]

    step_count = state.step_count + 1
    within = step_count < params.max_step
    success = (within & all_done & (fails_count == 0)).int()
    dones = status | ~within[:, None]

    # every droplet not done wears its footprint, within the step limit; the
    # band product counts at most N per cell, exact in float32
    band_y, band_x = _bands(params, center)
    live = (~dones & within[:, None]).float()
    usage = state.usage + torch.bmm((band_y * live[..., None]).transpose(1, 2),
                                    band_x)

    state = state._replace(center=center, sq_dist=sq_dist, status=status,
                           usage=usage, step_count=step_count,
                           fails_count=fails_count)
    out = StepOutput(
        obs=observe(params, state),
        rewards=rewards,
        team_reward=rewards.mean(dim=1),
        dones=dones,
        terminated=dones.all(dim=1),
        constraints=n_close,
        success=success,
    )
    return state, out


def step(params: MEDAParams, state: MEDAState, actions: torch.Tensor,
         generator: torch.Generator) -> Tuple[MEDAState, StepOutput]:
    """One step with move-success draws from ``generator``."""
    uniforms = torch.rand(actions.shape, generator=generator,
                          device=actions.device)
    return step_core(params, state, actions, uniforms)


# ---------------------------------------------------------------------------
# Observation (JAX meda.py:478-586)
# ---------------------------------------------------------------------------


def _footprints(params: MEDAParams, centers: torch.Tensor,
                origin: torch.Tensor, clip_border: bool) -> torch.Tensor:
    """(B, I, J, fov, fov) masks of body j in agent i's FOV, ``[row=y]
    [col=x]``.  Unclipped, only the part inside the FOV shows; clipped, the
    footprint is projected onto the FOV's border (JAX meda.py:478-500)."""
    fov = params.fov
    rows = torch.arange(fov, device=centers.device)
    rel = centers[:, None, :, :] - origin[:, :, None, :]    # (B, I, J, 2)
    lo, hi = rel - RADIUS, rel + RADIUS
    if clip_border:
        lo, hi = lo.clamp(0, fov - 1), hi.clamp(0, fov - 1)
    inside = (rows >= lo[..., None]) & (rows <= hi[..., None])  # (.., 2, fov)
    return inside[..., 1, :, None] & inside[..., 0, None, :]


def _max_paint(masks: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The largest id over the masks that cover a cell, (B, I, fov, fov)
    int32 (the reference's ascending overwrite); ``ids`` (B?, I?, J)."""
    return (masks * ids[..., None, None]).amax(dim=2)


def _boundary_layer(params: MEDAParams, center: torch.Tensor):
    """(B, I, fov, fov) walls: rows keyed by center_x against the *width*
    and columns by center_y against the *length* — the reference's literal
    formula (JAX meda.py:517-527)."""
    hf = params.fov // 2
    rows = torch.arange(params.fov, device=center.device)
    abs_r = center[..., 0, None] - hf + rows
    abs_c = center[..., 1, None] - hf + rows
    row_bad = (abs_r < 0) | (abs_r > params.width - 1)
    col_bad = (abs_c < 0) | (abs_c > params.length - 1)
    return row_bad[..., :, None] | col_bad[..., None, :]


def _rcp(x: float) -> float:
    """The float32 reciprocal by which XLA replaces a division by ``x``."""
    return float(np.float32(1.0) / np.float32(x))


def zoom(d: torch.Tensor, extent: int) -> torch.Tensor:
    """The v0.2 direction: an offset ``d`` on an axis of ``extent`` cells
    scaled to a 30-cell axis and rounded half to even, like ``jnp.round``
    (int32)."""
    return torch.round(d.float() * _rcp(extent / 30.0)).int()


def observe(params: MEDAParams, state: MEDAState) -> torch.Tensor:
    """Per-agent observations (B, N, obs_dim) of the params' version (JAX
    meda.py:530-586): float32 for v0 and v0.1, int8 for v0.2."""
    n, hf = params.n_droplets, params.fov // 2
    center, dest = state.center, state.dest
    B, device = center.shape[0], center.device
    origin = center - hf                                    # (B, I, 2)
    js = torch.arange(n, device=device)
    ids = (js + 1).to(torch.int32)
    own = (js[:, None] == js[None, :]).int()                # (I, J)
    other = 1 - own
    drops = _footprints(params, center, origin, False)
    dests_clip = _footprints(params, dest, origin, True)
    to_dest = dest - center                                 # (B, I, 2)

    if params.obs_version == "v0":
        dests = _footprints(params, dest, origin, False)
        layers = [_max_paint(drops, ids * own),
                  _max_paint(dests, ids * own),
                  _max_paint(drops, ids * other),
                  _max_paint(dests_clip, ids * other)]
        pixel = torch.stack(layers, dim=2).float().reshape(B, n, -1)
        return torch.cat([pixel, to_dest.float()], dim=-1)

    # v0.1 and v0.2: every droplet, and the goals of the other droplets
    # whose bodies reach into the FOV
    rel = center[:, None, :, :] - origin[:, :, None, :]     # (B, I, J, 2)
    observed = ((rel + RADIUS >= 0) & (rel - RADIUS <= params.fov - 1)
                ).all(dim=-1).int()
    l_drops = _max_paint(drops, ids)
    l_goals = _max_paint(dests_clip, ids * other * observed)
    l_bound = _boundary_layer(params, center).int()
    if params.obs_version == "v0.1":
        dests = _footprints(params, dest, origin, False)
        pixel = torch.stack([l_drops, _max_paint(dests, ids * own), l_goals,
                             l_bound], dim=2).float().reshape(B, n, -1)
        direction = torch.stack([
            to_dest[..., 1].float() * _rcp(params.width),
            to_dest[..., 0].float() * _rcp(params.length)], dim=-1)
        return torch.cat([pixel, direction], dim=-1)
    # v0.2: int8 layers, and the direction zoomed to a 30x30 board
    direction = torch.stack([zoom(to_dest[..., 1], params.width),
                             zoom(to_dest[..., 0], params.length)], dim=-1)
    pixel = torch.stack([l_drops, l_goals, l_bound], dim=2).reshape(B, n, -1)
    return torch.cat([pixel, direction], dim=-1).to(torch.int8)


def global_state(params: MEDAParams, state: MEDAState) -> torch.Tensor:
    """(B, 2*W*L) int8: the boards of droplet ids and destination ids, each
    cell the largest id whose footprint covers it — the QMIX mixer's state
    (JAX meda.py:588-602, which gives the same values in float32)."""
    ids = torch.arange(1, params.n_droplets + 1, dtype=torch.int8,
                       device=state.center.device)

    def board(centers):
        band_y, band_x = _bands(params, centers)             # (B, N, W|L)
        masks = band_y.bool()[..., :, None] & band_x.bool()[..., None, :]
        return (masks * ids[:, None, None]).amax(dim=1)      # (B, W, L)

    B = state.center.shape[0]
    return torch.stack([board(state.center), board(state.dest)],
                       dim=1).reshape(B, -1)
