"""The DMFB step in plain PyTorch (MARL-DMFB's ``env/DMFB/dmfb.py``):
sequential droplet moves with stalls, obstacles and move-success draws
against the electrode health, fluidic-constraint penalties, electrode wear,
and the v0 int8 observation (droplet ids, visible goals, blocks and walls,
the zoomed goal direction).

A state is a dict of the batched fields ``pos``, ``start``, ``goal``
(B, N, 2) int32 as (x, y), ``dist`` (B, N) int32, ``block_mask`` (B, W, L)
bool, ``health``, ``usage``, ``degrade`` (B, W, L) float32,
``step_count`` and ``cum_constraints`` (B,) int32.  ``cfg`` holds
``width``, ``length``, ``n_droplets``, ``fov`` and ``stall``.
"""

from __future__ import annotations

import numpy as np
import torch

STALL, RIGHT, LEFT, DOWN, UP = 0, 1, 2, 3, 4
N_ACTIONS = 5


def episode_limit(cfg: dict) -> int:
    return 2 * (cfg["width"] + cfg["length"])


def _move(cfg, s, actions, uniforms):
    """Droplet i's move sees droplets 0..i-1 already moved."""
    B, n = s["dist"].shape
    rows = torch.arange(B, device=actions.device)
    others = torch.arange(n, device=actions.device)
    pos, dist, goal = s["pos"].clone(), s["dist"].clone(), s["goal"]
    rewards = torch.zeros((B, n), dtype=torch.float32, device=actions.device)
    dx = (actions == RIGHT).int() - (actions == LEFT).int()
    dy = (actions == UP).int() - (actions == DOWN).int()
    for i in range(n):
        x0, y0 = pos[:, i, 0].clone(), pos[:, i, 1].clone()
        d0 = dist[:, i].clone()
        arrived = (d0 == 0) & cfg["stall"]
        moved = ~arrived & (uniforms[:, i] <= s["health"][rows, x0, y0])
        cx = (x0 + dx[:, i]).clamp(0, cfg["width"] - 1)
        cy = (y0 + dy[:, i]).clamp(0, cfg["length"] - 1)
        blocked = s["block_mask"][rows, cx, cy]
        cx, cy = torch.where(blocked, x0, cx), torch.where(blocked, y0, cy)
        taken = ((pos[..., 0] == cx[:, None]) & (pos[..., 1] == cy[:, None])
                 & (others != i)).any(dim=1)
        cx, cy = torch.where(taken, x0, cx), torch.where(taken, y0, cy)
        nx, ny = torch.where(moved, cx, x0), torch.where(moved, cy, y0)
        pos[:, i, 0], pos[:, i, 1] = nx, ny
        d1 = (nx - goal[:, i, 0]).abs() + (ny - goal[:, i, 1]).abs()
        same = d1 == d0
        r = torch.where(same & (d0 == 0), -0.1,
                        torch.where(same & (actions[:, i] == STALL), -0.25,
                                    torch.where(d1 < d0, -0.1, -0.4)))
        rewards[:, i] = torch.where(arrived, 0.0, r)
        dist[:, i] = torch.where(arrived, d0, d1)
    return pos, dist, rewards


def _close_counts(past, cur):
    """Per droplet: static (now) and dynamic (past against now) pairs at
    squared distance under 4."""
    n = cur.shape[1]
    off = ~torch.eye(n, dtype=torch.bool, device=cur.device)

    def close(a, b):
        d = a[:, :, None, :] - b[:, None, :, :]
        return ((d * d).sum(-1) < 4) & off

    static = close(cur, cur).sum(2, dtype=torch.int32)
    pc = close(past, cur)
    dynamic = pc.sum(2, dtype=torch.int32) + pc.sum(1, dtype=torch.int32)
    return static, dynamic


def step(cfg: dict, s: dict, actions: torch.Tensor, uniforms: torch.Tensor):
    """One step of B chips: ``(new_state, out)``, ``out`` holding ``obs``
    (B, N, 3*fov*fov+2) int8, ``rewards`` (B, N), ``team_reward``,
    ``terminated`` (B,) bool, ``constraints``, ``success`` (B,) int32."""
    actions = actions.to(torch.int32)
    done_before = s["dist"] == 0
    pos, dist, rewards = _move(cfg, s, actions, uniforms)
    static, dynamic = _close_counts(s["pos"], pos)
    constraints = static.sum(1, dtype=torch.int32) + dynamic.sum(
        1, dtype=torch.int32)
    rewards = rewards - 2.0 * static - 2.0 * dynamic
    if cfg["stall"]:
        rewards = torch.where(done_before, 0.0, rewards)
    all_done = (dist == 0).all(1)
    rewards = rewards + torch.where(
        all_done, torch.where(constraints == 0, 20.0, 10.0), 0.0)[:, None]
    steps = s["step_count"] + 1
    B, W, L = s["usage"].shape
    wear = torch.zeros((B, W * L), dtype=torch.float32, device=pos.device)
    wear.scatter_add_(1, (pos[..., 0] * L + pos[..., 1]).long(),
                      (dist != 0).float())
    cum = s["cum_constraints"] + constraints
    within = steps < episode_limit(cfg)
    new = dict(s, pos=pos, dist=dist, usage=s["usage"] + wear.view(B, W, L),
               step_count=steps, cum_constraints=cum)
    dones = (dist == 0) | ~within[:, None]
    out = {"obs": observe(cfg, new), "rewards": rewards,
           "team_reward": rewards.mean(1), "terminated": dones.all(1),
           "constraints": constraints,
           "success": (within & all_done & (cum == 0)).int()}
    return new, out


def _zoom(d, hf, extent):
    """The goal direction: exact inside the view, else scaled toward a
    10-cell range with the float32 reciprocal, rounded half to even."""
    rcp = float(np.float32(1.0) / np.float32((extent - hf) / (10 - hf)))
    far_pos = torch.round((d - hf).float() * rcp).int() + hf
    far_neg = torch.round((d + hf).float() * rcp).int() - hf
    return torch.where(d.abs() > hf, torch.where(d > 0, far_pos, far_neg), d)


def observe(cfg: dict, s: dict) -> torch.Tensor:
    """The v0 observation of every droplet, int8."""
    fov, n = cfg["fov"], cfg["n_droplets"]
    hf = fov // 2
    pos, goal = s["pos"], s["goal"]
    B, dev = pos.shape[0], pos.device
    cells = torch.arange(fov, device=dev)
    # ids are taken as int8 before the max, as the reference stores them
    ids = torch.arange(1, n + 1, device=dev).to(torch.int8).int()
    corner = pos - hf

    def paint(at, values):
        hit = ((at[..., 0, None, None] == cells[:, None])
               & (at[..., 1, None, None] == cells[None, :]))
        return (hit * values[..., None, None]).amax(2)

    own = paint(pos[:, None] - corner[:, :, None], ids)
    near = (pos[:, None] - pos[:, :, None]).abs() <= hf
    seen = near[..., 0] & near[..., 1] & ~torch.eye(n, dtype=torch.bool,
                                                    device=dev)
    goals = paint((goal[:, None] - corner[:, :, None]).clamp(0, fov - 1),
                  ids * seen)
    blocks = s["block_mask"][:, None, :fov, :fov].int().expand(B, n, fov, fov)
    ax = corner[..., 0, None] + cells
    ay = corner[..., 1, None] + cells
    wall = (((ax < 0) | (ax > cfg["width"] - 1))[..., :, None]
            | ((ay < 0) | (ay > cfg["length"] - 1))[..., None, :])
    blocks = torch.where(wall, 1, blocks)
    direction = torch.stack(
        [_zoom(goal[..., 0] - pos[..., 0], hf, cfg["width"]),
         _zoom(goal[..., 1] - pos[..., 1], hf, cfg["length"])], -1)
    pixel = torch.stack([own, goals, blocks], 2).reshape(B, n, -1)
    return torch.cat([pixel, direction], -1).to(torch.int8)


def start_faults(cfg: dict, s: dict) -> int:
    """Chips whose new task breaks what a task is: droplets on their start
    cells, on the board, 2N cells at squared distance over 2 from each
    other, ``dist`` the Manhattan distance, the counters at zero."""
    W, L = cfg["width"], cfg["length"]
    pts = torch.cat([s["start"], s["goal"]], 1)
    on_board = ((pts[..., 0] >= 0) & (pts[..., 0] < W) & (pts[..., 1] >= 0)
                & (pts[..., 1] < L)).all(1)
    d = pts[:, :, None] - pts[:, None]
    sq = (d * d).sum(-1)
    off = ~torch.eye(pts.shape[1], dtype=torch.bool, device=pts.device)
    spaced = ((sq > 2) | ~off).all(2).all(1)
    ok = (on_board & spaced
          & (s["pos"] == s["start"]).all(2).all(1)
          & (s["dist"] == (s["start"] - s["goal"]).abs().sum(-1)).all(1)
          & (s["step_count"] == 0) & (s["cum_constraints"] == 0))
    return int((~ok).sum())
