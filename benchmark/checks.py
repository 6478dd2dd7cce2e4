"""The comparison that decides ``correct``: what the timed path produced,
judged by the plain reference, each number against its cell's limit.

The numbers (each ``value <= limit`` passes):

* ``start_faults``: chips whose new task breaks what a task is (exact, 0);
* ``rollout_mismatch``: stored episode elements that differ from the
  reference's replay of the same chips with the same draws (exact, 0);
* ``act_gap``: the widest gap by which a greedy stored action's reference
  Q lies below the reference's best;
* ``reward_gap``: the widest gap of a stored team reward (a float32 mean
  over the agents) from the reference's;
* ``replay_mismatch``: ring rows that differ from the episodes stored into
  them, and minibatch rows that differ from the ring's rows at the drawn
  indices (exact, 0);
* ``loss_gap``: the widest relative gap between the program's loss and the
  reference's over the first three updates;
* ``grad_gap``, ``delta_gap``: by the worst leaf, the gap between the
  norms of the program's and the reference's first clipped gradient (read
  from Adam's first moment after one update) and of the weights' change
  after three updates, over the larger of the reference leaf's norm and
  the median leaf's; leaves whose reference gradient is under a thousandth
  of the median leaf's are left out (their change is round-off);
* ``ema_gap``: the widest relative gap of the program's averaged weights
  after its first cycle from the average taken in float64;
* ``target_mismatch``: target-net elements that differ from the weights
  of the update that last synced them (exact, 0).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from benchmark.reference import learner as ref_learner
from benchmark.reference import rollout as ref_rollout

LIMITS = Path(__file__).resolve().parent / "limits"
EPISODE_KEYS = ("o_ext", "u", "r", "padded", "terminated")


def load_limits(cell: str) -> dict:
    """The cell's limits file: ``limits`` and ``not_compared``."""
    path = LIMITS / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def verdict(numbers: dict, limits: dict):
    """``(correct, [(name, value, limit)])``: every number within its
    limit, leaving out those the limits file does not compare; a number
    without a limit is not correct."""
    skip = set(limits.get("not_compared", ()))
    lim = limits.get("limits", {})
    rows = [(k, v, lim.get(k)) for k, v in numbers.items() if k not in skip]
    ok = all(lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows


def views(data: dict, n_agents: int) -> dict:
    """Ring rows in their stored layout -> the learner's (b, T, N, .)
    views."""
    o = data["o_ext"]
    return {"o_ext": o.view(*o.shape[:-1], n_agents, o.shape[-1] // n_agents),
            "u": data["u"][..., None], "r": data["r"][..., None],
            "padded": data["padded"][..., None],
            "terminated": data["terminated"][..., None]}


def stored_layout(episodes: dict) -> dict:
    """A rollout's episodes (B, T, N, .) -> the ring's stored layout."""
    return {"o_ext": episodes["o_ext"].flatten(2),
            "u": episodes["u"][..., 0], "r": episodes["r"][..., 0],
            "padded": episodes["padded"][..., 0],
            "terminated": episodes["terminated"][..., 0]}


def count_unequal(a: dict, b: dict) -> int:
    return sum(int((a[k] != b[k].to(a[k].dtype)).sum()) for k in a)


def judge_rollout(cfg: dict, w0: dict, start, gen_state, episodes: dict,
                  epsilon: float, rows_global: int, rows=None,
                  draw_rows=None, control: bool = False) -> dict:
    """Judge a rollout's chips ``rows`` (all where None) from its start
    state (the program's state tuple after the reset), the generator state
    its draws began at, and its stored episodes.  The draws are made at
    the global batch's ``rows_global`` rows; ``draw_rows`` are the judged
    chips' rows of it (``rows`` where None: one device)."""
    T = episodes["u"].shape[1]
    dev = episodes["u"].device
    rand_a, explore, uniforms = ref_rollout.draws(
        gen_state, dev, T, rows_global, cfg["n_droplets"], cfg["n_actions"])
    if rows is None:
        rows = torch.arange(episodes["u"].shape[0], device=dev)
    if draw_rows is None:
        draw_rows = rows
    start = {k: v[rows] for k, v in start._asdict().items()}
    stored = {k: episodes[k][rows] for k in EPISODE_KEYS}
    env = ref_rollout.env_module(cfg["kind"])
    out = ref_rollout.judge(cfg, w0, start, rand_a[:, draw_rows],
                            explore[:, draw_rows], uniforms[:, draw_rows],
                            epsilon, stored, control=control)
    res = {"start_faults": env.start_faults(cfg, start),
           "rollout_mismatch": out["mismatch"], "act_gap": out["act_gap"],
           "reward_gap": out["reward_gap"]}
    if control:
        res["control.act_gap"] = out["control_gap"]
        res["control.reward_gap"] = out["control_reward_gap"]
    if out["mismatch"]:
        res.update({f"mismatch.{k}": v for k, v in out["detail"].items()})
    return res


def _norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the norms of ``prog`` and ``ref``, over
    the larger of the reference leaf's norm and the median leaf's."""
    pn, rn = _norms(prog), _norms(ref)
    scale = sorted(rn[k] for k in keep)[len(keep) // 2]
    return max(abs(pn[k] - rn[k]) / max(rn[k], scale, 1e-30) for k in keep)


def kept_leaves(g_ref: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    n = _norms(g_ref)
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= 1e-3 * med]


def learner_numbers(losses_p, g1_p, w3_p, losses_r, g1_r, w3_r, w0) -> dict:
    keep = kept_leaves(g1_r)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(losses_p,
                                                          losses_r)),
        "grad_gap": leaf_gap(g1_p, g1_r, keep),
        "delta_gap": leaf_gap({k: w3_p[k] - w0[k] for k in keep},
                              {k: w3_r[k] - w0[k] for k in keep}, keep),
    }


def judge_learner(cfg: dict, w0: dict, batches: list, losses_p: list,
                  mu1_p: dict, w3_p: dict, calibrate: bool = False) -> dict:
    """The program's first updates against the reference's on the same
    minibatches, from the same weights.  With ``calibrate`` also the
    control (the reference in TF32 in the program's place) and the planted
    half-batch fault, each judged as the program is."""
    losses_r, g1_r, w3_r = ref_learner.updates(w0, batches, cfg)
    b1 = cfg["adam_betas"][0]
    g1_p = {k: v / (1 - b1) for k, v in mu1_p.items()}
    res = learner_numbers(losses_p, g1_p, w3_p, losses_r, g1_r, w3_r, w0)
    if calibrate:
        c = ref_learner.updates(w0, batches, cfg, control=True)
        res.update({f"control.{k}": v for k, v in learner_numbers(
            *c, losses_r, g1_r, w3_r, w0).items()})
        f = ref_learner.updates(w0, batches, cfg, half_batch=True)
        res.update({f"half_batch.{k}": v for k, v in learner_numbers(
            *f, losses_r, g1_r, w3_r, w0).items()})
    return res


def ema_gap(before: dict, live: dict, after: dict, decay: float) -> float:
    """The program's averaged weights after one EMA step against the
    average ``decay * before + (1 - decay) * live`` taken in float64, the
    worst leaf's largest gap over its largest weight."""
    worst = 0.0
    for k, e in before.items():
        ref = decay * e.double() + (1.0 - decay) * live[k].double()
        worst = max(worst, float((after[k].double() - ref).abs().max()
                                 / ref.abs().max().clamp_min(1e-30)))
    return worst
