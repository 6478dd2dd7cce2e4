"""The DMFB v0.1 observation, batched over B chips and N agents (JAX
``envs/dmfb_v01.py:30-153``, reference ``DMFBenv_v0_1.getOneObs``).

Four float32 layers over each agent's FOV, then the goal direction:

0. the ids of the droplets in the FOV, the agent's own included;
1. the agent's own goal, clipped into the FOV (below 10 droplets; from 10
   on, only where it is inside);
2. the goals of the other droplets that the agent sees, projected toward
   the FOV's border along each droplet's direction to its goal, written in
   ascending order of remaining distance (ties by id) and moved to the
   first free neighbour where the cell is taken;
3. the blocks at ABSOLUTE board cells ``[0, fov)`` (the reference quirk of
   the v0 observation), and walls where the FOV leaves the board;

and ``[(goal_y - y) / length, (goal_x - x) / width]``, each a multiply by
the float32 reciprocal, as XLA compiles the JAX package's division.

The projection's ceil/floor divisions are exact integer divisions, as in
the JAX package.  Layer 2 is order-dependent, so it is written one rank at
a time (N steps), each step over all chips and agents at once.  The kernel
in ``csrc/dmfb_step.cu`` does not compute this observation: on the card a
v0.1 step is the kernel's transition, then :func:`observe_v01`.
"""

from __future__ import annotations

import numpy as np
import torch

from marl_dmfb_tpu_torch.envs.dmfb import (DMFBParams, DMFBState,
                                           _boundary_overlay)

_BIG = 1 << 20   # sort key of the droplets an agent does not see


def _floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _ceil_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return -_floor_div(-a, b)


def _projected_goals(params: DMFBParams, rel: torch.Tensor,
                     delta: torch.Tensor, order: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Layer 2: ``rel`` (B, I, J, 2) droplet j's cell in agent i's FOV,
    ``delta`` (B, J, 2) its offset to its goal, ``order`` (B, I, N) the
    droplets by rank, ``valid`` (B, I, N) whether the droplet of a rank is
    seen.  Returns (B, I, fov, fov) float32 (JAX dmfb_v01.py:67-140)."""
    fov = params.fov
    B, I, n = order.shape
    canvas = torch.zeros((B, I, fov * fov), dtype=torch.float32,
                         device=rel.device)
    delta = delta[:, None].expand(B, I, n, 2)

    def at(a, b):
        """The canvas at (a, b), indices clipped as the JAX package's."""
        cell = a.clamp(0, fov - 1) * fov + b.clamp(0, fov - 1)
        return canvas.gather(2, cell[..., None])[..., 0]

    for k in range(n):
        j = order[..., k]                                    # (B, I)
        pick = lambda t: t.gather(2, j[..., None])[..., 0]
        x, y = pick(rel[..., 0]), pick(rel[..., 1])
        dx, dy = pick(delta[..., 0]), pick(delta[..., 1])
        boundx = torch.where(dx >= 0, fov - 1 - x, -x)
        boundy = torch.where(dy >= 0, fov - 1 - y, -y)
        exact = (dx.abs() <= boundx.abs()) & (dy.abs() <= boundy.abs())
        safe_dy = torch.where(dy == 0, 1, dy)
        safe_dx = torch.where(dx == 0, 1, dx)
        cdx_f = torch.where(
            dx >= 0,
            torch.minimum(boundx, _ceil_div(dx * boundy, safe_dy)),
            torch.maximum(boundx, _floor_div(dx * boundy, safe_dy)))
        cdy_f = torch.where(
            dy >= 0,
            torch.minimum(boundy, _ceil_div(dy * boundx, safe_dx)),
            torch.maximum(boundy, _floor_div(dy * boundx, safe_dx)))
        # the reference's branch chain: exact, dx == 0, dy == 0, formula
        zero = torch.zeros_like(dx)
        cdx = torch.where(exact, dx, torch.where(
            dx == 0, zero, torch.where(dy == 0, boundx, cdx_f)))
        cdy = torch.where(exact, dy, torch.where(
            dx == 0, boundy, torch.where(dy == 0, zero, cdy_f)))
        ti, tj = x + cdx, y + cdy

        free0 = at(ti, tj) == 0
        samecell = (ti == x) & (tj == y)
        ok1 = (ti + 1 < fov) & (at(ti + 1, tj) == 0)
        ok2 = (ti - 1 >= 0) & (at(ti - 1, tj) == 0)
        ok3 = (tj + 1 < fov) & (at(ti, tj + 1) == 0)
        ok4 = (tj - 1 >= 0) & (at(ti, tj - 1) == 0)
        # the first free cell in the reference's order
        si = torch.where(free0, ti, torch.where(
            ok1, ti + 1, torch.where(ok2, ti - 1, ti)))
        sj = torch.where(free0 | ok1 | ok2, tj, torch.where(
            ok3, tj + 1, torch.where(ok4, tj - 1, tj)))
        write = valid[..., k] & (free0 | (~samecell & (ok1 | ok2 | ok3 | ok4)))
        cell = (si.clamp(0, fov - 1) * fov + sj.clamp(0, fov - 1))[..., None]
        new = torch.where(write, (j + 1).float(),
                          canvas.gather(2, cell)[..., 0])
        canvas.scatter_(2, cell, new[..., None])
    return canvas.view(B, I, fov, fov)


def observe_v01(params: DMFBParams, state: DMFBState) -> torch.Tensor:
    """Per-agent v0.1 observations (B, N, 4*fov*fov + 2) float32."""
    fov, hf, n = params.fov, params.fov // 2, params.n_droplets
    pos, goal = state.pos.long(), state.goal.long()
    B, device = pos.shape[0], pos.device
    rows = torch.arange(fov, device=device)
    js = torch.arange(n, device=device)
    origin = pos - hf                                       # (B, I, 2)
    rel = pos[:, None] - origin[:, :, None]                 # (B, I, J, 2)
    relx, rely = rel[..., 0], rel[..., 1]

    def paint(cx, cy, values):
        """(B, I, J) FOV cells and values -> (B, I, fov, fov), the largest
        value per cell."""
        hit = ((cx[..., None, None] == rows[:, None])
               & (cy[..., None, None] == rows[None, :]))
        return (hit * values[..., None, None]).amax(dim=2)

    # layer 0: every droplet's id at its cell, the agent's own included
    layer0 = paint(relx, rely, (js + 1).expand(B, n, n)).float()
    inside = (relx >= 0) & (relx < fov) & (rely >= 0) & (rely < fov)
    seeing = inside & (js[:, None] != js[None, :])          # (B, I, J)

    # layer 1: the agent's own goal
    g_rel = goal - origin                                   # (B, I, 2)
    if n < 10:
        g1 = g_rel.clamp(0, fov - 1)
        own = torch.ones((B, n), dtype=torch.bool, device=device)
    else:
        g1 = g_rel
        own = ((g_rel >= 0) & (g_rel < fov)).all(dim=-1)
    layer1 = paint(g1[..., None, 0], g1[..., None, 1],
                   (own * (js + 1))[..., None]).float()

    # layer 2: the seen droplets' goals, projected, by ascending distance
    dist = (pos - goal).abs().sum(dim=-1)                   # (B, J)
    key = torch.where(seeing, dist[:, None, :] * n + js, _BIG)
    order = key.argsort(dim=-1)             # unique keys where it matters
    valid = key.gather(2, order) < _BIG
    layer2 = _projected_goals(params, rel, goal - pos, order, valid)

    # layer 3: blocks at absolute cells, then the walls
    layer3 = state.block_mask[:, None, :fov, :fov].float().expand(
        B, n, fov, fov)
    layer3 = _boundary_overlay(params, layer3, origin).float()

    # XLA turns the JAX package's division by a constant into a multiply by
    # its float32 reciprocal (as for the v0 zoom, dmfb.zoom_reciprocals)
    rcp = lambda extent: float(np.float32(1.0) / np.float32(extent))
    direction = torch.stack([
        (goal[..., 1] - pos[..., 1]).float() * rcp(params.length),
        (goal[..., 0] - pos[..., 0]).float() * rcp(params.width),
    ], dim=-1)
    pixel = torch.stack([layer0, layer1, layer2, layer3], dim=2)
    return torch.cat([pixel.reshape(B, n, -1), direction], dim=-1)
