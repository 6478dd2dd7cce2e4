"""DMFB droplet-routing environment in PyTorch, batched over B chips.

Ported from ``marl_dmfb_tpu/envs/dmfb.py``.  Where the JAX package wrote a
single-chip function and ``vmap``-ed it, every function here takes tensors
with a leading batch axis B.  Where JAX split a PRNG key, the functions here
take an explicit ``torch.Generator``; the two give different numbers from
one seed, so task generation is held to its invariants, and the transition
itself (:func:`step_core`) takes its move-success draws as an argument so
that tests can replay the JAX package's draws.

:func:`step_core` (:func:`transition`, then :func:`observe`) is the plain
version of the hand kernel in ``csrc/dmfb_step.cu``; ``ops/dmfb_step.py``
dispatches between the two by device.  The observation is the v0 int8 one,
or with ``obs_version="v0.1"`` the 4-layer float32 one of
``envs/dmfb_v01.py``, which the kernel does not compute.

Coordinates follow the JAX package: the board is ``[x][y]`` with shape
``(width, length)``; ``pos[b, i] = (x, y)``.  Actions: STALL=0, RIGHT=1
(x+1), LEFT=2 (x-1), DOWN=3 (y-1), UP=4 (y+1).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

STALL, RIGHT, LEFT, DOWN, UP = 0, 1, 2, 3, 4
N_ACTIONS = 5


@dataclasses.dataclass(frozen=True)
class DMFBParams:
    """Static environment configuration (JAX dmfb.py:47-141)."""

    width: int = 10
    length: int = 10
    n_droplets: int = 4
    n_blocks: int = 0
    fov: int = 9
    stall: bool = True
    b_degrade: bool = False
    per_degrade: float = 0.1
    obs_version: str = "v0"   # "v0" (3 int8 layers) or "v0.1" (4 float32)

    def __post_init__(self):
        if self.obs_version not in ("v0", "v0.1"):
            raise ValueError(f"unknown DMFB observation {self.obs_version!r}")
        if self.fov > min(self.width, self.length):
            raise RuntimeError("Fov is too large")
        droplet_limit = int((self.width + 1) * (self.length + 1) / 9)
        if self.n_droplets > droplet_limit:
            raise TypeError("Too many droplets for DMFB")
        if self.width < 5 or self.length < 5:
            raise ValueError("board must be at least 5x5")
        if self.fov % 2 != 1:
            raise ValueError("fov must be odd")
        if _spacing_p_valid(self.width, self.length, self.n_droplets) < 1e-6:
            warnings.warn(
                f"{self.n_droplets} droplets on a {self.width}x"
                f"{self.length} board: random task generation is "
                "statistically infeasible; tasks use a randomized "
                "densest-packing lattice instead of uniform sampling",
                stacklevel=2,
            )

    @property
    def max_step(self) -> int:
        return (self.width + self.length) * 2

    @property
    def episode_limit(self) -> int:
        return self.max_step

    @property
    def n_layers(self) -> int:
        return 4 if self.obs_version == "v0.1" else 3

    @property
    def obs_dim(self) -> int:
        return self.n_layers * self.fov * self.fov + 2

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        # (channels, fov, fov, vector length, flattened size)
        return (self.n_layers, self.fov, self.fov, 2, self.obs_dim)

    @property
    def obs_dtype(self) -> torch.dtype:
        return torch.int8 if self.obs_version == "v0" else torch.float32

    @property
    def state_dim(self) -> int:
        return 3 * self.width * self.length

    def zoom_reciprocals(self) -> Tuple[float, float]:
        """float32 ``1/scale`` per axis for :func:`_zoom_dir`.

        The JAX package divides by a Python-float scale inside ``jit``, and
        XLA folds ``x / const`` into ``x * (1/const)`` with the reciprocal
        taken in float32.  The port multiplies by the same reciprocal so that
        round-half-even ties land the same way (they differ from a true
        division on some boards, e.g. where ``scale`` is not a power of 2).
        """
        hf = self.fov // 2
        return tuple(
            float(np.float32(1.0) / np.float32((extent - hf) / (10 - hf)))
            for extent in (self.width, self.length)
        )

    def env_info(self) -> dict:
        return {
            "n_actions": N_ACTIONS,
            "n_agents": self.n_droplets,
            "obs_shape": self.obs_shape,
            "state_shape": self.state_dim,
            "episode_limit": self.episode_limit,
        }


class DMFBState(NamedTuple):
    """Dynamic state of B chips.  The JAX state's PRNG ``key`` is gone: the
    caller passes a ``torch.Generator`` instead."""

    pos: torch.Tensor              # (B, N, 2) int32 — droplet (x, y)
    start: torch.Tensor            # (B, N, 2) int32 — task start cells
    goal: torch.Tensor             # (B, N, 2) int32 — task goal cells
    dist: torch.Tensor             # (B, N) int32 — Manhattan distance to goal
    block_mask: torch.Tensor       # (B, W, L) bool — obstacle cells
    health: torch.Tensor           # (B, W, L) f32 — move-success probability
    usage: torch.Tensor            # (B, W, L) f32 — actuations since decay
    degrade: torch.Tensor          # (B, W, L) f32 — per-cell decay factor
    step_count: torch.Tensor       # (B,) int32
    cum_constraints: torch.Tensor  # (B,) int32


class StepOutput(NamedTuple):
    obs: torch.Tensor          # (B, N, obs_dim) obs_dtype; None from
    #                            transition()
    rewards: torch.Tensor      # (B, N) f32
    team_reward: torch.Tensor  # (B,) f32 — mean over agents
    dones: torch.Tensor        # (B, N) bool
    terminated: torch.Tensor   # (B,) bool — all agents done
    constraints: torch.Tensor  # (B,) int32 — violations this step
    success: torch.Tensor      # (B,) int32


# ---------------------------------------------------------------------------
# Task generation (JAX dmfb.py:175-356)
# ---------------------------------------------------------------------------


def _spacing_p_valid(width: int, length: int, n_droplets: int) -> float:
    """Estimated probability that one uniform draw of 2N cells satisfies the
    pairwise sq-dist > 2 constraint."""
    n2 = 2 * n_droplets
    pairs = n2 * (n2 - 1) / 2
    return float((1.0 - 9.0 / (width * length)) ** pairs)


def _gen_rounds(params: DMFBParams) -> int:
    """Candidate rounds sized so the lattice fallback is ~e^-8 unlikely."""
    p = _spacing_p_valid(params.width, params.length, params.n_droplets)
    if p < 1e-6:
        return 32
    return min(4096, max(32, int(8.0 / max(p, 1e-9))))


def _lattice(width: int, length: int, x0: int, y0: int) -> np.ndarray:
    xs = np.arange(x0, width, 2)
    ys = np.arange(y0, length, 2)
    return np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)


def _fallback_lattice(params: DMFBParams, batch: int,
                      generator: torch.Generator,
                      device: torch.device) -> torch.Tensor:
    """Randomized valid placement on the spacing-2 lattice, used where every
    sampled round violates the spacing constraint (JAX dmfb.py:201-244)."""
    need = 2 * params.n_droplets
    even = _lattice(params.width, params.length, 0, 0)
    if even.shape[0] < need:
        pool = np.concatenate([
            even,
            _lattice(params.width, params.length, 1, 1),
            _lattice(params.width, params.length, 0, 1),
            _lattice(params.width, params.length, 1, 0),
        ])[:need]
        pts = torch.as_tensor(pool, dtype=torch.int32, device=device)
        perm = torch.rand((batch, need), generator=generator,
                          device=device).argsort(dim=1)
        return pts[perm]
    cells = torch.as_tensor(even, dtype=torch.int32, device=device)
    sel = torch.rand((batch, cells.shape[0]), generator=generator,
                     device=device).argsort(dim=1)[:, :need]
    pts = cells[sel]                                        # (B, 2N, 2)
    hi = torch.tensor([params.width - 1, params.length - 1],
                      dtype=torch.int32, device=device)
    flip = torch.rand((batch, 1, 2), generator=generator, device=device) < 0.5
    return torch.where(flip, hi - pts, pts)


def generate_start_end(params: DMFBParams, batch: int,
                       generator: torch.Generator,
                       device: torch.device) -> torch.Tensor:
    """Sample 2N cells per chip with pairwise squared distance > 2: a fixed
    number of candidate sets, the first valid one taken (JAX
    dmfb.py:247-267).  Returns (B, 2N, 2) int32."""
    n2 = 2 * params.n_droplets
    rounds = _gen_rounds(params)
    x = torch.randint(0, params.width, (batch, rounds, n2),
                      generator=generator, device=device, dtype=torch.int32)
    y = torch.randint(0, params.length, (batch, rounds, n2),
                      generator=generator, device=device, dtype=torch.int32)
    valid = torch.ones((batch, rounds), dtype=torch.bool, device=device)
    for i in range(n2):
        for j in range(i + 1, n2):
            dx = x[..., i] - x[..., j]
            dy = y[..., i] - y[..., j]
            valid &= dx * dx + dy * dy > 2
    first = valid.to(torch.uint8).argmax(dim=1)             # first valid round
    rows = torch.arange(batch, device=device)
    pts = torch.stack([x[rows, first], y[rows, first]], dim=-1)
    fallback = _fallback_lattice(params, batch, generator, device)
    return torch.where(valid.any(dim=1)[:, None, None], pts, fallback)


def generate_blocks(params: DMFBParams, generator: torch.Generator,
                    starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``n_blocks`` non-overlapping 2x2 obstacles per chip, each anchored
    uniformly over the anchors whose block neither holds a start/end cell nor
    overlaps an earlier block (JAX dmfb.py:270-331).  Returns (B, W, L)
    bool."""
    batch, device = starts.shape[0], starts.device
    W, L = params.width, params.length
    mask = torch.zeros((batch, W, L), dtype=torch.bool, device=device)
    if params.n_blocks == 0 or params.n_blocks * 4 / (W * L) > 0.2:
        return mask
    pts = torch.cat([starts, ends], dim=1).long()           # (B, 2N, 2)
    pt_map = torch.zeros((batch, W * L), dtype=torch.bool, device=device)
    pt_map.scatter_(1, pts[..., 0] * L + pts[..., 1], True)
    pt_map = pt_map.view(batch, W, L)
    nx, ny = W - 3, L - 3                   # anchors: [0, W-4] x [0, L-4]
    ix = torch.arange(W, device=device)[None, :, None]
    iy = torch.arange(L, device=device)[None, None, :]
    for _ in range(params.n_blocks):
        occ = pt_map | mask
        # bad(x, y) = any occupied cell in {x, x+1} x {y, y+1}
        bad = (occ[:, :nx, :ny] | occ[:, 1:nx + 1, :ny]
               | occ[:, :nx, 1:ny + 1] | occ[:, 1:nx + 1, 1:ny + 1])
        valid = ~bad.reshape(batch, -1)
        score = torch.rand((batch, nx * ny), generator=generator,
                           device=device)
        flat = torch.where(valid, score, -1.0).argmax(dim=1)
        ax = (flat // ny)[:, None, None]
        ay = (flat % ny)[:, None, None]
        patch = (ix - ax >= 0) & (ix - ax < 2) & (iy - ay >= 0) & (iy - ay < 2)
        mask = mask | (patch & valid.any(dim=1)[:, None, None])
    return mask


def random_degrade_map(params: DMFBParams, batch: int,
                       generator: torch.Generator,
                       device: torch.device) -> torch.Tensor:
    """Per-cell decay factors: uniform in [0.6, 1.0) on a ``per_degrade``
    share of cells, 1.0 elsewhere (JAX dmfb.py:334-343)."""
    shape = (batch, params.width, params.length)
    if not params.b_degrade:
        return torch.ones(shape, dtype=torch.float32, device=device)
    m = torch.rand(shape, generator=generator, device=device) * 0.4 + 0.6
    sel = torch.rand(shape, generator=generator, device=device)
    return torch.where(sel < 1.0 - params.per_degrade, 1.0, m)


def _new_task(params: DMFBParams, batch: int, generator: torch.Generator,
              device: torch.device):
    pts = generate_start_end(params, batch, generator, device)
    starts = pts[:, : params.n_droplets].contiguous()
    ends = pts[:, params.n_droplets:].contiguous()
    block_mask = generate_blocks(params, generator, starts, ends)
    dist = (starts - ends).abs().sum(dim=-1, dtype=torch.int32)
    return starts, ends, dist, block_mask


def init(params: DMFBParams, batch: int, generator: torch.Generator,
         device) -> DMFBState:
    """B fresh chips: new tasks, full health (JAX dmfb.py:356-374)."""
    device = torch.device(device)
    starts, ends, dist, block_mask = _new_task(params, batch, generator,
                                               device)
    shape = (batch, params.width, params.length)
    zeros_b = torch.zeros((batch,), dtype=torch.int32, device=device)
    return DMFBState(
        pos=starts,
        start=starts,
        goal=ends,
        dist=dist,
        block_mask=block_mask,
        health=torch.ones(shape, dtype=torch.float32, device=device),
        usage=torch.zeros(shape, dtype=torch.float32, device=device),
        degrade=random_degrade_map(params, batch, generator, device),
        step_count=zeros_b,
        cum_constraints=zeros_b.clone(),
    )


def update_health(state: DMFBState) -> DMFBState:
    """Decay cells whose usage exceeded 50 actuations (JAX dmfb.py:377-384)."""
    worn = state.usage > 50.0
    return state._replace(
        health=torch.where(worn, state.health * state.degrade, state.health),
        usage=torch.where(worn, 0.0, state.usage),
    )


def reset(params: DMFBParams, state: DMFBState,
          generator: torch.Generator) -> DMFBState:
    """New random tasks; the wear maps persist (JAX dmfb.py:387-409 with
    ``new=False``, the only setting the port's callers use)."""
    batch, device = state.pos.shape[0], state.pos.device
    starts, ends, dist, block_mask = _new_task(params, batch, generator,
                                               device)
    zeros_b = torch.zeros((batch,), dtype=torch.int32, device=device)
    state = state._replace(
        pos=starts, start=starts, goal=ends, dist=dist, block_mask=block_mask,
        step_count=zeros_b, cum_constraints=zeros_b.clone(),
    )
    return update_health(state)


def restart(params: DMFBParams, state: DMFBState) -> DMFBState:
    """Same tasks from the start (JAX dmfb.py:412-421)."""
    zeros_b = torch.zeros_like(state.step_count)
    return state._replace(
        pos=state.start,
        dist=(state.start - state.goal).abs().sum(dim=-1, dtype=torch.int32),
        step_count=zeros_b,
        cum_constraints=zeros_b.clone(),
    )


# ---------------------------------------------------------------------------
# Step (JAX dmfb.py:429-610)
# ---------------------------------------------------------------------------


def _move_droplets(params: DMFBParams, pos, dist, goal, block_mask, health,
                   actions, uniforms):
    """Sequential per-droplet moves: droplet i's overlap check sees droplets
    0..i-1 already moved and i+1..N-1 at their old cells (JAX
    dmfb.py:429-505)."""
    batch, n = dist.shape
    rows = torch.arange(batch, device=pos.device)
    droplets = torch.arange(n, device=pos.device)
    pos = pos.clone()
    dist = dist.clone()
    rewards = torch.zeros((batch, n), dtype=torch.float32, device=pos.device)
    # action deltas by comparison, as the kernel does: an action outside
    # [0, 5) moves nothing (JAX: a zero one-hot row)
    dx = (actions == RIGHT).int() - (actions == LEFT).int()
    dy = (actions == UP).int() - (actions == DOWN).int()
    for i in range(n):
        old_x, old_y = pos[:, i, 0].clone(), pos[:, i, 1].clone()
        d_old = dist[:, i].clone()
        already = (d_old == 0) & params.stall
        prob = health[rows, old_x, old_y]
        moved = ~already & (uniforms[:, i] <= prob)
        cx = (old_x + dx[:, i]).clamp(0, params.width - 1)
        cy = (old_y + dy[:, i]).clamp(0, params.length - 1)
        on_block = block_mask[rows, cx, cy]
        cx = torch.where(on_block, old_x, cx)
        cy = torch.where(on_block, old_y, cy)
        occupied = ((pos[..., 0] == cx[:, None]) & (pos[..., 1] == cy[:, None])
                    & (droplets != i)).any(dim=1)
        cx = torch.where(occupied, old_x, cx)
        cy = torch.where(occupied, old_y, cy)
        new_x = torch.where(moved, cx, old_x)
        new_y = torch.where(moved, cy, old_y)
        pos[:, i, 0] = new_x
        pos[:, i, 1] = new_y
        d_new = (new_x - goal[:, i, 0]).abs() + (new_y - goal[:, i, 1]).abs()
        same = d_new == d_old
        r = torch.where(
            same & (d_old == 0), -0.1,
            torch.where(same & (actions[:, i] == STALL), -0.25,
                        torch.where(d_new < d_old, -0.1, -0.4)),
        )
        rewards[:, i] = torch.where(already, 0.0, r)
        dist[:, i] = torch.where(already, d_old, d_new)
    return pos, dist, rewards


def _conflicts(pasts: torch.Tensor, curs: torch.Tensor):
    """Static + dynamic fluidic-constraint counts per droplet (JAX
    dmfb.py:508-527): pairs closer than 2 (squared distance < 4)."""
    n = curs.shape[1]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=curs.device)

    def close(a, b):
        d = a[:, :, None, :] - b[:, None, :, :]
        return ((d * d).sum(dim=-1) < 4) & off_diag

    sta = close(curs, curs).sum(dim=2, dtype=torch.int32)
    close_pc = close(pasts, curs)
    dy = (close_pc.sum(dim=2, dtype=torch.int32)
          + close_pc.sum(dim=1, dtype=torch.int32))
    return sta, dy


def transition(params: DMFBParams, state: DMFBState, actions: torch.Tensor,
               uniforms: torch.Tensor) -> Tuple[DMFBState, StepOutput]:
    """One transition of B chips with injected move-success draws
    ``uniforms`` (B, N), without the observation (``obs`` is None) — the
    plain version of the CUDA kernel's no-observation mode."""
    actions = actions.to(torch.int32)
    dones_pre = state.dist == 0
    new_pos, new_dist, rewards = _move_droplets(
        params, state.pos, state.dist, state.goal, state.block_mask,
        state.health, actions, uniforms,
    )
    sta, dy = _conflicts(state.pos, new_pos)
    constraints = sta.sum(dim=1, dtype=torch.int32) + dy.sum(
        dim=1, dtype=torch.int32)
    rewards = rewards - 2.0 * sta - 2.0 * dy
    if params.stall:
        rewards = torch.where(dones_pre, 0.0, rewards)
    all_done = (new_dist == 0).all(dim=1)
    bonus = torch.where(all_done,
                        torch.where(constraints == 0, 20.0, 10.0), 0.0)
    rewards = rewards + bonus[:, None]

    step_count = state.step_count + 1
    # not-yet-done droplets wear their cell
    batch, L = new_pos.shape[0], params.length
    cells = (new_pos[..., 0] * L + new_pos[..., 1]).long()
    wear = torch.zeros((batch, params.width * L), dtype=torch.float32,
                       device=new_pos.device)
    wear.scatter_add_(1, cells, (new_dist != 0).float())
    usage = state.usage + wear.view_as(state.usage)
    cum_constraints = state.cum_constraints + constraints

    within_limit = step_count < params.max_step
    success = (within_limit & all_done & (cum_constraints == 0)).int()
    dones = (new_dist == 0) | ~within_limit[:, None]

    state = state._replace(
        pos=new_pos, dist=new_dist, usage=usage, step_count=step_count,
        cum_constraints=cum_constraints,
    )
    out = StepOutput(
        obs=None,
        rewards=rewards,
        team_reward=rewards.mean(dim=1),
        dones=dones,
        terminated=dones.all(dim=1),
        constraints=constraints,
        success=success,
    )
    return state, out


def step_core(params: DMFBParams, state: DMFBState, actions: torch.Tensor,
              uniforms: torch.Tensor) -> Tuple[DMFBState, StepOutput]:
    """One step of B chips with injected move-success draws: the transition,
    then the observation of the new state (JAX dmfb.py:429-610) — the plain
    version of the CUDA kernel."""
    state, out = transition(params, state, actions, uniforms)
    return state, out._replace(obs=observe(params, state))


def step(params: DMFBParams, state: DMFBState, actions: torch.Tensor,
         generator: torch.Generator) -> Tuple[DMFBState, StepOutput]:
    """One transition with move-success draws from ``generator``."""
    uniforms = torch.rand(actions.shape, generator=generator,
                          device=actions.device)
    return step_core(params, state, actions, uniforms)


# ---------------------------------------------------------------------------
# Observation (JAX dmfb.py:617-712)
# ---------------------------------------------------------------------------


def _boundary_overlay(params: DMFBParams, layer, origin):
    """Paint FOV rows/cols whose absolute coordinate is off the board as
    walls.  ``layer`` (B, N, fov, fov); ``origin`` (B, N, 2) FOV corner."""
    rows = torch.arange(params.fov, device=layer.device)
    abs_x = origin[..., 0, None] + rows                     # (B, N, fov)
    abs_y = origin[..., 1, None] + rows
    row_bad = (abs_x < 0) | (abs_x > params.width - 1)
    col_bad = (abs_y < 0) | (abs_y > params.length - 1)
    bad = row_bad[..., :, None] | col_bad[..., None, :]
    return torch.where(bad, 1, layer)


def _zoom_dir(params: DMFBParams, d: torch.Tensor, rcp: float):
    """Direction-vector zoom for goals outside the FOV: the exact offset
    inside the FOV, else rescaled toward a 10x10 range.  ``torch.round`` is
    round-half-even, like Python's ``round`` in the reference."""
    hf = params.fov // 2
    pos_z = torch.round((d - hf).float() * rcp).int() + hf
    neg_z = torch.round((d + hf).float() * rcp).int() - hf
    return torch.where(d.abs() > hf, torch.where(d > 0, pos_z, neg_z), d)


def observe(params: DMFBParams, state: DMFBState) -> torch.Tensor:
    """Per-agent observations (B, N, obs_dim) of the params' version (JAX
    dmfb.py:703-712)."""
    if params.obs_version == "v0.1":
        from marl_dmfb_tpu_torch.envs.dmfb_v01 import observe_v01

        return observe_v01(params, state)
    return observe_v0(params, state)


def observe_v0(params: DMFBParams, state: DMFBState) -> torch.Tensor:
    """Per-agent v0 observations (B, N, 3*fov*fov + 2) int8: droplet ids,
    visible droplets' goals, blocks + walls, zoomed goal direction."""
    fov, hf, n = params.fov, params.fov // 2, params.n_droplets
    pos, goal = state.pos, state.goal
    batch, device = pos.shape[0], pos.device
    rows = torch.arange(fov, device=device)
    # JAX takes the ids as int8 before the max: id 128 wraps to -128 and
    # loses to the 0s of the droplets elsewhere, 256 wraps to 0
    ids = torch.arange(1, n + 1, device=device).to(torch.int8).int()
    origin = pos - hf                                       # (B, N, 2)

    def paint(cells, values):
        """cells (B, I, J, 2) FOV coords of J markers per agent I; values
        (B?, I?, J) ids -> (B, I, fov, fov) with the max id per cell."""
        hit = ((cells[..., 0, None, None] == rows[:, None])
               & (cells[..., 1, None, None] == rows[None, :]))
        return (hit * values[..., None, None]).amax(dim=2)

    # layer 0: droplet j's id at its cell in agent i's FOV
    layer0 = paint(pos[:, None] - origin[:, :, None], ids)
    # layer 1: goals of the other droplets visible to agent i, clipped into
    # the FOV; the max id wins where two land on one cell
    near = (pos[:, None] - pos[:, :, None]).abs() <= hf     # (B, I, J, 2)
    visible = (near[..., 0] & near[..., 1]
               & ~torch.eye(n, dtype=torch.bool, device=device))
    layer1 = paint((goal[:, None] - origin[:, :, None]).clamp(0, fov - 1),
                   ids * visible)
    # layer 2: blocks at ABSOLUTE board coords [0, fov) (a reference quirk
    # the JAX package keeps), then the walls overwrite
    layer2 = state.block_mask[:, None, :fov, :fov].int().expand(
        batch, n, fov, fov)
    layer2 = _boundary_overlay(params, layer2, origin)

    rcp_x, rcp_y = params.zoom_reciprocals()
    direction = torch.stack([
        _zoom_dir(params, goal[..., 0] - pos[..., 0], rcp_x),
        _zoom_dir(params, goal[..., 1] - pos[..., 1], rcp_y),
    ], dim=-1)
    pixel = torch.stack([layer0, layer1, layer2], dim=2).reshape(batch, n, -1)
    return torch.cat([pixel, direction], dim=-1).to(torch.int8)


def global_state(params: DMFBParams, state: DMFBState) -> torch.Tensor:
    """(B, 3*W*L) int8: the board of droplet ids, the board of goal ids
    (each cell the sum of the ids on it, as the JAX package's one-hot
    contraction) and the blocks — the QMIX mixer's state as the JAX
    package's int8 ring stores it (JAX dmfb.py:715-734 gives float32,
    which the ring's conversion saturates at 127, replay.py:74, 118)."""
    ids = torch.arange(1, params.n_droplets + 1, dtype=torch.int32,
                       device=state.pos.device)
    xs = torch.arange(params.width, device=state.pos.device)
    ys = torch.arange(params.length, device=state.pos.device)

    def id_board(cells):
        on_x = cells[..., 0, None] == xs                    # (B, N, W)
        on_y = cells[..., 1, None] == ys                    # (B, N, L)
        hit = on_x[..., :, None] & on_y[..., None, :]
        return (hit * ids[:, None, None]).sum(dim=1)

    boards = torch.stack([id_board(state.pos), id_board(state.goal),
                          state.block_mask.int()], dim=1)
    return boards.reshape(boards.shape[0], -1).clamp(max=127).to(torch.int8)
