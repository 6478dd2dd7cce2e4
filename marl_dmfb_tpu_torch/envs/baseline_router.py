"""The deterministic staircase router for MEDA, on the host (JAX
``envs/baseline_router.py``; the reference's ``BaseLineRouter``,
env/MEDA/meda.py:348-454).

A non-RL baseline: it plans x-then-y staircase paths droplet by droplet,
avoiding the earlier droplets' paths in space and time, then estimates the
reward those paths reach, exactly on a healthy chip or in expectation under
a degraded health map.  It is an offline analysis tool, so it is plain
NumPy.

The reference's quirks, kept as the JAX package keeps them:

* where no collision-free insertion of the x-moves into the y-moves
  exists, the fallback path is discarded (meda.py:423-428 assigns it to a
  dead variable), which leaves that droplet an empty action list;
* paths are padded with Action N (meda.py:363-367).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from marl_dmfb_tpu_torch.envs import meda as tmeda

E, W, S, N_ = 1, 3, 2, 0
R = tmeda.RADIUS


def _move_center(c, action, width, length):
    d = tmeda.ACTION_DELTAS[action]
    x = int(np.clip(c[0] + d[0], R, length - 1 - R))
    y = int(np.clip(c[1] + d[1], R, width - 1 - R))
    return (x, y)


def _footprint(c):
    return {(y, x)
            for y in range(c[1] - R, c[1] + R + 1)
            for x in range(c[0] - R, c[0] + R + 1)}


def _check_valid_move(next_c, prev_c, road_map, next_v):
    """Scan the newly covered cells against the earlier paths' time stamps
    (reference checkValidMove/getScanArea, meda.py:438-454)."""
    scan = _footprint(next_c) - _footprint(prev_c)
    for r_map in road_map:
        for (y, x) in scan:
            v = r_map[y][x]
            if next_v - 1 <= v <= next_v + 1:
                return False
    return True


def _mark(road_map_entry, c, value):
    for (y, x) in _footprint(c):
        road_map_entry[y][x] = value


def plan_path(road_map, start, dest, width, length) -> List[int]:
    """The staircase path of one droplet, avoiding the earlier paths in
    ``road_map``, to which it adds its own (reference addPath,
    meda.py:396-436)."""
    delta_x = dest[0] - start[0]
    delta_y = dest[1] - start[1]
    x_moves = ([E] * int(delta_x / 3) if delta_x > 0
               else [W] * int(abs(delta_x) / 3))
    y_moves = ([S] * int(delta_y / 3) if delta_y > 0
               else [N_] * int(abs(delta_y) / 3))
    actions: List[int] = []
    for i in range(len(x_moves)):
        path = x_moves[:i] + y_moves + x_moves[i:]
        valid = True
        cur = start
        for j, act in enumerate(path):
            nxt = _move_center(cur, act, width, length)
            if _check_valid_move(nxt, cur, road_map, j + 1):
                cur = nxt
            else:
                valid = False
                break
        if valid:
            actions = path
            break
    # (the reference's fallback is dead code: the path stays empty)
    this_map = np.full((width, length), -1, dtype=np.int64)
    cur = start
    for step, act in enumerate(actions):
        _mark(this_map, cur, step)
        cur = _move_center(cur, act, width, length)
    _mark(this_map, cur, len(actions))
    road_map.append(this_map)
    return actions


def estimated_reward(params: tmeda.MEDAParams, state: tmeda.MEDAState,
                     m_health: Optional[np.ndarray] = None,
                     index: int = 0) -> Tuple[float, float]:
    """Plan every droplet of chip ``index`` of ``state`` and estimate the
    reward (reference getEstimatedReward, meda.py:353-389).

    Returns (the sum of the per-step mean rewards, the longest path) on a
    healthy chip, or (the expected discounted reward, the expected longest
    time) under ``m_health``."""
    width, length = params.width, params.length
    starts = state.start[index].cpu().numpy()
    dests = state.dest[index].cpu().numpy()
    n = params.n_droplets

    road_map: list = []
    trajectories = [
        plan_path(road_map, tuple(starts[i]), tuple(dests[i]), width, length)
        for i in range(n)
    ]
    max_step = max((len(t) for t in trajectories), default=0)
    for t in trajectories:
        t += [N_] * (max_step - len(t))

    # Simulate the manager-level moves (the reference calls moveDroplets
    # with all-ones health, meda.py:371-372: no step bonuses or wear; it
    # then takes np.average over the whole (rewards, fail, status) tuple,
    # which raises on ragged input, so as shipped it cannot run; this is
    # its evident intent, the mean of the per-droplet rewards).
    centers = [tuple(starts[i]) for i in range(n)]
    status = [False] * n
    sq = lambda a, b: (a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2
    rewards = []
    steps = np.zeros(n)
    for t in range(max_step):
        if m_health is not None:
            probs = np.array([
                np.mean(np.asarray(m_health)[
                    c[1] - R:c[1] + R + 1, c[0] - R:c[0] + R + 1
                ]) for c in centers
            ])
        step_r = np.zeros(n)
        for i in range(n):
            if status[i]:
                continue
            d = tuple(dests[i])
            sq_old = sq(centers[i], d)
            if sq_old < tmeda.SQ_GOAL:
                centers[i] = d
                status[i] = True
                continue
            centers[i] = _move_center(centers[i], trajectories[i][t],
                                      width, length)
            sq_new = sq(centers[i], d)
            if sq_new < tmeda.SQ_GOAL:
                step_r[i] = 0.0
            elif sq_new == sq_old and trajectories[i][t] == 8:
                step_r[i] = -0.2
            elif sq_new < sq_old:
                step_r[i] = -0.08
            else:
                step_r[i] = -0.4
        # punish (meda.py:321-330)
        for i in range(n - 1):
            for j in range(i + 1, n):
                if sq(centers[i], centers[j]) < tmeda.SQ_PUNISH:
                    step_r[i] -= 0.6
                    step_r[j] -= 0.6
        np_r = float(np.mean(step_r))
        if m_health is None:
            rewards.append(np_r)
        else:
            fail = 1.0 - probs
            disc = (np_r * probs - 0.9 * fail * probs
                    - 1.8 * fail * fail * probs)
            rewards.append(float(np.nanmean(disc)))
            steps = steps + 1.0 / probs
    if m_health is None:
        return sum(rewards), max_step
    return sum(rewards), float(steps.max()) if n else 0.0
