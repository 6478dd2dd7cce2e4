"""The actor loop in plain PyTorch, run alongside a rollout that the
measured program produced, to judge it chip by chip and step by step.

From a chip's task at the rollout's start and the rollout's random draws,
the reference observes, runs the net (float32, its own hidden state), and
steps the env with the action that the program stored, so that one action
near a tie in the Qs does not send the rest of the episode elsewhere.  It
counts every stored element that differs from what the reference produces
(observations, ``padded``, ``terminated``, the actions of explored steps,
the actions and rewards of steps after the episode ended), and reads the
widest gap by which a greedy stored action's Q lies below the reference's
best and the widest gap of a stored team reward from the reference's.
With ``control`` it also reads what the precision one step below the
configuration's would give: the gap of the action that the net in TF32
puts first on the same inputs, and the gap of the team reward averaged in
bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import dmfb, meda, net
from benchmark.reference.precision import float32, tf32


def env_module(kind: str):
    return {"dmfb": dmfb, "meda": meda}[kind]


def draws(gen_state: torch.Tensor, device, T: int, rows: int, n: int,
          n_actions: int, greedy: bool = False):
    """The draws a rollout of ``rows`` x ``n`` makes each of its T steps,
    in its order, from a generator at ``gen_state``: the random actions
    and the exploration draws (unless ``greedy``), then the move-success
    draws; each (T, rows, n)."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    rand_a, explore, uniforms = [], [], []
    for _ in range(T):
        if not greedy:
            rand_a.append(torch.randint(0, n_actions, (rows, n), generator=g,
                                        device=device, dtype=torch.int32))
            explore.append(torch.rand((rows, n), generator=g, device=device))
        uniforms.append(torch.rand((rows, n), generator=g, device=device))
    stack = lambda xs: torch.stack(xs) if xs else None
    return stack(rand_a), stack(explore), stack(uniforms)


def judge(cfg: dict, w: dict, start: dict, rand_a, explore, uniforms,
          epsilon: float, episodes: dict, control: bool = False) -> dict:
    """Judge R chips' stored episodes (``o_ext`` (R, T+1, N, obs), ``u``
    (R, T, N, 1), ``r``, ``padded``, ``terminated`` (R, T, 1)) from their
    start ``start`` (a state dict of R rows) and draws (T, R, N).  Returns
    ``mismatch`` (a count; ``detail`` by kind), ``act_gap`` (the widest gap, 0.0 where no step
    was greedy), ``reward_gap`` and, with ``control``, ``control_gap`` and
    ``control_reward_gap``."""
    float32()
    env = env_module(cfg["kind"])
    T, A, H = episodes["u"].shape[1], cfg["n_actions"], cfg["rnn_hidden"]
    R, N = episodes["u"].shape[0], episodes["u"].shape[2]
    dev = episodes["u"].device
    eps = torch.tensor(epsilon, dtype=torch.float32, device=dev)
    state = dict(start)
    obs = env.observe(cfg, state)
    detail = {"obs0": int((episodes["o_ext"][:, 0] != obs).sum())}

    def count(key, wrong):
        detail[key] = detail.get(key, 0) + int(wrong.sum())

    h = torch.zeros((R * N, H), device=dev)
    h_ctl = h.clone()
    last = torch.zeros((R, N, A), device=dev)
    live = torch.ones(R, dtype=torch.bool, device=dev)
    act_gap = ctl_gap = reward_gap = ctl_reward = 0.0
    for t in range(T):
        x = obs.float()
        if cfg["last_action"]:
            x = torch.cat([x, last], -1)
        x = x.reshape(R * N, -1)
        q, h = net.forward(w, x, h, cfg)
        q = q.view(R, N, A)
        a = episodes["u"][:, t, :, 0].long()
        best = q.amax(-1)
        explored = (explore[t] < eps if explore is not None
                    else torch.zeros((R, N), dtype=torch.bool, device=dev))
        greedy = live[:, None] & ~explored
        gaps = torch.where(greedy, best - q.gather(-1, a[..., None])[..., 0],
                           0.0)
        act_gap = max(act_gap, float(gaps.max()))
        if control:
            with tf32():
                qc, h_ctl = net.forward(w, x, h_ctl, cfg)
            pick = qc.view(R, N, A).argmax(-1, keepdim=True)
            ctl_gap = max(ctl_gap, float(torch.where(
                greedy, best - q.gather(-1, pick)[..., 0], 0.0).max()))
        if rand_a is not None:
            count("explored_action", live[:, None] & explored & (a != rand_a[t]))
        count("ended_action", ~live[:, None] & (a != 0))
        new, out = env.step(cfg, state, a, uniforms[t])
        state = {k: torch.where(live.view(-1, *[1] * (v.dim() - 1)), new[k], v)
                 for k, v in state.items()}
        lv = live[:, None, None]
        expect = {
            "o_next": torch.where(lv, out["obs"], 0),
            "r": torch.where(live, out["team_reward"], 0.0),
            "padded": ~live,
            "terminated": torch.where(live, out["terminated"], True),
        }
        count("o_next", episodes["o_ext"][:, t + 1] != expect["o_next"])
        for k in ("padded", "terminated"):
            count(k, episodes[k][:, t, 0] != expect[k])
        # the team reward is a float32 mean, whose last bit depends on the
        # order of its sum: held by its gap; after the end it is 0 exactly
        r = episodes["r"][:, t, 0]
        count("ended_reward", ~live & (r != 0))
        reward_gap = max(reward_gap, float(torch.where(
            live, (r - expect["r"]).abs(), 0.0).max()))
        if control:   # the team reward averaged in bfloat16
            low = out["rewards"].to(torch.bfloat16).mean(1).float()
            ctl_reward = max(ctl_reward, float(torch.where(
                live, (low - expect["r"]).abs(), 0.0).max()))
        live = live & ~out["terminated"]
        obs = out["obs"]
        last = F.one_hot(a, A).float()
    out = {"mismatch": sum(detail.values()), "act_gap": act_gap,
           "reward_gap": reward_gap, "detail": detail}
    if control:
        out["control_gap"] = ctl_gap
        out["control_reward_gap"] = ctl_reward
    return out
