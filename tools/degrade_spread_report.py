#!/usr/bin/env python3
"""Summarise the degradation sweeps' seed spread, port against JAX.

    python3 tools/degrade_spread_report.py \\
        [--spread marl_dmfb_tpu_torch/artifacts/degrade_seed_spread.json]

Reads the seed-spread artifact (the port's sweeps of a DegreData row at
several seeds on the card, the JAX package's on the CPU; written by
``tools/degrade_sweeps_torch.py --seeds`` and ``tools/degrade_seeds_jax.py``)
and prints one JSON line a row with, for each package, the seeds, the mean
and standard deviation of the first epoch below 0.5 success, and the mean
steps an episode before the collapse (the epochs before JAX's earliest
collapse less 2: the actuations that wear the electrodes); the difference
of the two means in standard errors (``z``); and for each package the
seeds whose curve passes the single-seed block criterion of
``tests/test_torch_degrade_sweeps.py::test_sweep_follows_jax`` against the
JAX package's committed seed-12 curve (``artifacts/DegreData``): every
5-epoch block within 4 binomial sigma of 500 episodes.  Numpy only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.degrade_sweeps_torch import SPREAD, TASKS  # noqa: E402

BLOCK = 5
SIGMAS = 4.0


def first_below_half(success) -> int:
    below = np.flatnonzero(np.asarray(success) < 0.5)
    return int(below[0]) if below.size else len(success)


def blocks_hold(success, committed) -> bool:
    """``test_sweep_follows_jax``'s block criterion: each 5-epoch block's
    mean success within 4 binomial sigma of the committed curve's."""
    n = BLOCK * TASKS * 5
    for b in range(0, len(committed), BLOCK):
        pj = float(np.mean(committed[b:b + BLOCK]))
        pp = float(np.mean(success[b:b + BLOCK]))
        aj, ap = (n * pj + 2) / (n + 4), (n * pp + 2) / (n + 4)
        if abs(pp - pj) > SIGMAS * np.sqrt(aj * (1 - aj) / n
                                           + ap * (1 - ap) / n):
            return False
    return True


def z(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    return float((a.mean() - b.mean()) / se) if se else 0.0


def report(spread: dict) -> list:
    lines = []
    for row in sorted(set(spread.get("torch", {}))
                      & set(spread.get("jax", {}))):
        committed = np.load(os.path.join(ROOT, "artifacts", "DegreData", row,
                                         "success.npy")).mean(axis=0)
        sides = {p: spread[p][row] for p in ("torch", "jax")}
        first = {p: [first_below_half(r["success"]) for r in s.values()]
                 for p, s in sides.items()}
        pre = max(1, min(first["jax"]) - 2)
        steps = {p: [float(np.mean(r["steps"][:pre])) for r in s.values()]
                 for p, s in sides.items()}
        line = {"row": row, "pre_collapse_epochs": pre,
                "z_first_below_half": z(first["torch"], first["jax"]),
                "z_pre_collapse_steps": z(steps["torch"], steps["jax"])}
        for p, s in sides.items():
            line[p] = {
                "seeds": sorted(int(k) for k in s),
                "first_below_half_mean": float(np.mean(first[p])),
                "first_below_half_sd": float(np.std(first[p], ddof=1)),
                "pre_collapse_steps_mean": float(np.mean(steps[p])),
                "pass_single_seed_blocks": sorted(
                    int(k) for k, r in s.items()
                    if blocks_hold(r["success"], committed)),
            }
        lines.append(line)
    return lines


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--spread", default=SPREAD)
    a = p.parse_args(argv)
    with open(a.spread) as f:
        lines = report(json.load(f))
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
