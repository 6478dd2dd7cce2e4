"""The MEDA step in plain PyTorch (MARL-DMFB's ``env/MEDA/meda.py``):
5x5-cell droplets moving 3 cells straight or 2 diagonally, snapping onto a
destination within reach, moving with the mean health under the
footprint, -0.6 per too-close pair, footprint wear, and the v0.2 int8
observation (droplet bodies, other droplets' destinations clipped into the
view, walls, the direction zoomed to a 30-cell board).

A state is a dict of ``center``, ``start``, ``dest`` (B, N, 2) int32 as
(x, y), ``sq_dist`` (B, N) int32, ``status`` (B, N) bool, ``health``,
``usage``, ``degrade`` (B, W, L) float32 indexed [y][x], ``step_count``
and ``fails_count`` (B,) int32.  ``cfg`` holds ``width`` (the y extent),
``length`` (the x extent), ``n_droplets`` and ``fov``.
"""

from __future__ import annotations

import numpy as np
import torch

N_ACTIONS = 9
STALL = 8
RADIUS = 2
SQ_GOAL = 16
SQ_PUNISH = 36
SQ_SPACING = 81


def episode_limit(cfg: dict) -> int:
    return cfg["width"] + cfg["length"]


def _rcp(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def _sq(a, b):
    d = a - b
    return (d * d).sum(-1, dtype=torch.int32)


def _mean_health(health, center):
    """The mean health under each 5x5 footprint: down the columns, then
    across, times the float32 reciprocal of 25."""
    B, W, L = health.shape
    off = torch.arange(-RADIUS, RADIUS + 1, device=center.device)
    ys = (center[..., 1, None] + off).long()
    xs = (center[..., 0, None] + off).long()
    idx = ys[..., :, None] * L + xs[..., None, :]
    win = health.reshape(B, 1, W * L).expand(B, center.shape[1], W * L)
    win = win.gather(2, idx.flatten(2)).view(idx.shape)
    col = win[..., 0, :]
    for r in range(1, 5):
        col = col + win[..., r, :]
    total = col[..., 0]
    for c in range(1, 5):
        total = total + col[..., c]
    return total * _rcp(25)


def _deltas(a):
    """(dx, dy) of N, E, S, W (3 cells), NE, SE, SW, NW (2), STALL."""
    k = lambda *acts: sum((a == x).int() for x in acts)
    dx = 3 * (k(1) - k(3)) + 2 * (k(4, 5) - k(6, 7))
    dy = 3 * (k(2) - k(0)) + 2 * (k(5, 6) - k(4, 7))
    return torch.stack([dx, dy], -1)


def _bands(cfg, center):
    ys = torch.arange(cfg["width"], device=center.device)
    xs = torch.arange(cfg["length"], device=center.device)
    return (((ys - center[..., 1, None]).abs() <= RADIUS).float(),
            ((xs - center[..., 0, None]).abs() <= RADIUS).float())


def step(cfg: dict, s: dict, actions: torch.Tensor, uniforms: torch.Tensor):
    """One step of B chips: ``(new_state, out)`` as the DMFB reference's."""
    a = actions.to(torch.int32)
    done, c, dest = s["status"], s["center"], s["dest"]
    snap = ~done & (s["sq_dist"] < SQ_GOAL)
    moved = ~done & ~snap & (uniforms <= _mean_health(s["health"], c))
    to = c + _deltas(a)
    cand = torch.stack([to[..., 0].clamp(RADIUS, cfg["length"] - 1 - RADIUS),
                        to[..., 1].clamp(RADIUS, cfg["width"] - 1 - RADIUS)],
                       -1)
    new_c = torch.where(snap[..., None], dest,
                        torch.where(moved[..., None], cand, c))
    sq_new = _sq(new_c, dest)
    r = torch.where(sq_new < SQ_GOAL, 0.0,
                    torch.where((sq_new == s["sq_dist"]) & (a == STALL), -0.2,
                                torch.where(sq_new < s["sq_dist"], -0.08,
                                            -0.4)))
    rewards = torch.where(done | snap, 0.0, r)
    sq_out = torch.where(done, s["sq_dist"],
                         torch.where(snap, torch.zeros_like(sq_new), sq_new))
    center = torch.where(done[..., None], c, new_c)
    status = done | snap
    n = center.shape[1]
    d = center[:, :, None] - center[:, None]
    close = ((d * d).sum(-1) < SQ_PUNISH) & ~torch.eye(
        n, dtype=torch.bool, device=center.device)
    per = close.sum(2, dtype=torch.int32)
    n_close = per.sum(1, dtype=torch.int32)
    rewards = rewards - 0.6 * per.float()
    fails = s["fails_count"] + n_close
    all_done = status.all(1)
    rewards = rewards + torch.where(
        all_done, torch.where(fails == 0, 6.0, 3.0), 0.0)[:, None]
    steps = s["step_count"] + 1
    within = steps < episode_limit(cfg)
    dones = status | ~within[:, None]
    band_y, band_x = _bands(cfg, center)
    live = (~dones & within[:, None]).float()
    usage = s["usage"] + torch.bmm((band_y * live[..., None]).transpose(1, 2),
                                   band_x)
    new = dict(s, center=center, sq_dist=sq_out, status=status, usage=usage,
               step_count=steps, fails_count=fails)
    out = {"obs": observe(cfg, new), "rewards": rewards,
           "team_reward": rewards.mean(1), "terminated": dones.all(1),
           "constraints": n_close,
           "success": (within & all_done & (fails == 0)).int()}
    return new, out


def _footprints(cfg, centers, corner, clip):
    fov = cfg["fov"]
    cells = torch.arange(fov, device=centers.device)
    rel = centers[:, None, :, :] - corner[:, :, None, :]
    lo, hi = rel - RADIUS, rel + RADIUS
    if clip:
        lo, hi = lo.clamp(0, fov - 1), hi.clamp(0, fov - 1)
    inside = (cells >= lo[..., None]) & (cells <= hi[..., None])
    return inside[..., 1, :, None] & inside[..., 0, None, :]


def observe(cfg: dict, s: dict) -> torch.Tensor:
    """The v0.2 observation of every droplet, int8: the largest id over
    the bodies covering a cell, the other droplets' destinations clipped
    into the view where their bodies reach into it, the walls, then the
    direction scaled to a 30-cell board."""
    n, fov = cfg["n_droplets"], cfg["fov"]
    hf = fov // 2
    c, dest = s["center"], s["dest"]
    B, dev = c.shape[0], c.device
    corner = c - hf
    js = torch.arange(n, device=dev)
    ids = (js + 1).int()
    other = 1 - (js[:, None] == js[None, :]).int()
    rel = c[:, None] - corner[:, :, None]
    seen = ((rel + RADIUS >= 0) & (rel - RADIUS <= fov - 1)).all(-1).int()
    bodies = (_footprints(cfg, c, corner, False)
              * ids[..., None, None]).amax(2)
    goals = (_footprints(cfg, dest, corner, True)
             * (ids * other * seen)[..., None, None]).amax(2)
    cells = torch.arange(fov, device=dev)
    ar = c[..., 0, None] - hf + cells
    ac = c[..., 1, None] - hf + cells
    walls = (((ar < 0) | (ar > cfg["width"] - 1))[..., :, None]
             | ((ac < 0) | (ac > cfg["length"] - 1))[..., None, :]).int()
    to = dest - c
    direction = torch.stack(
        [torch.round(to[..., 1].float() * _rcp(cfg["width"] / 30.0)).int(),
         torch.round(to[..., 0].float() * _rcp(cfg["length"] / 30.0)).int()],
        -1)
    pixel = torch.stack([bodies, goals, walls], 2).reshape(B, n, -1)
    return torch.cat([pixel, direction], -1).to(torch.int8)


def start_faults(cfg: dict, s: dict) -> int:
    """Chips whose new task breaks what a task is: bodies on the board,
    starts and destinations each at squared distance 81 or more from the
    others of their kind, no destination body over its own start, droplets
    on their starts, ``sq_dist`` the squared distance, nothing latched, the
    counters at zero."""
    W, L = cfg["width"], cfg["length"]
    n = cfg["n_droplets"]
    off = ~torch.eye(n, dtype=torch.bool, device=s["start"].device)
    ok = torch.ones(s["start"].shape[0], dtype=torch.bool,
                    device=s["start"].device)
    for pts in (s["start"], s["dest"]):
        ok &= ((pts[..., 0] >= RADIUS) & (pts[..., 0] <= L - 1 - RADIUS)
               & (pts[..., 1] >= RADIUS) & (pts[..., 1] <= W - 1 - RADIUS)
               ).all(1)
        d = pts[:, :, None] - pts[:, None]
        ok &= (((d * d).sum(-1) >= SQ_SPACING) | ~off).all(2).all(1)
    over = ((s["dest"] - s["start"]).abs() <= 2 * RADIUS).all(-1).any(1)
    ok &= (~over & (s["center"] == s["start"]).all(2).all(1)
           & (s["sq_dist"] == _sq(s["start"], s["dest"])).all(1)
           & ~s["status"].any(1) & (s["step_count"] == 0)
           & (s["fails_count"] == 0))
    return int((~ok).sum())
