"""Episode replay ring on the device (JAX ``replay.py:34-134, 243-252``).

The ring holds whole episodes in the JAX package's merged layout: ``o_ext``
``(S, T+1, N*obs_dim)`` in the env's observation dtype, int8 for v0 and
float32 for v0.1 (``o = o_ext[:, :T]``, ``o_next = o_ext[:, 1:]``),
``u`` ``(S, T, N)`` int8, ``r``, ``padded`` and ``terminated``
``(S, T)``, and for QMIX the global states ``s_ext`` ``(S, T+1,
state_dim)`` int8 (the boards hold small ids; ``s = s_ext[:, :T]``,
``s_next = s_ext[:, 1:]``).  :func:`store` writes a rollout's B episodes in
place at a modulo cursor (a 10x10-4d ring of 5000 episodes is 201 MB, so
there is no functional copy), and :func:`sample` draws a uniform minibatch
with replacement and hands it over in the ``(b, T, N, .)`` views the
learner reads.  The cursor and the size are host integers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ReplayState(NamedTuple):
    data: dict     # str -> (S, T, ...) tensors, merged layout
    cursor: int    # next write slot
    size: int      # number of valid episodes


def init_replay(capacity: int, episode_limit: int, n_agents: int,
                obs_dim: int, obs_dtype=torch.int8, device="cpu",
                state_dim: Optional[int] = None) -> ReplayState:
    """An empty ring of ``capacity`` episodes; with ``state_dim``, also
    their global states (JAX replay.py:58-107)."""
    S, T, N = capacity, episode_limit, n_agents
    kw = dict(device=device)
    data = {
        "o_ext": torch.zeros((S, T + 1, N * obs_dim), dtype=obs_dtype, **kw),
        "u": torch.zeros((S, T, N), dtype=torch.int8, **kw),
        "r": torch.zeros((S, T), dtype=torch.float32, **kw),
        "padded": torch.zeros((S, T), dtype=torch.bool, **kw),
        "terminated": torch.zeros((S, T), dtype=torch.bool, **kw),
    }
    if state_dim is not None:
        data["s_ext"] = torch.zeros((S, T + 1, state_dim), dtype=torch.int8,
                                    **kw)
    return ReplayState(data=data, cursor=0, size=0)


def _flatten_episodes(episodes: dict) -> dict:
    """Rollout layout ``(B, T, N, .)`` -> the ring's merged layout."""
    out = {}
    for k, v in episodes.items():
        if k == "o_ext":
            out[k] = v.reshape(v.shape[0], v.shape[1], -1)
        elif k == "s_ext":   # (B, T+1, state_dim) already
            out[k] = v
        else:   # u (B, T, N, 1); r, padded, terminated (B, T, 1)
            out[k] = v[..., 0]
    return out


def logical_views(data: dict) -> dict:
    """Merged layout -> the ``(b, T, N, .)`` views the learner reads (views,
    no copies)."""
    u = data["u"]
    N = u.shape[-1]
    o = data["o_ext"]
    views = {
        "o_ext": o.view(*o.shape[:-1], N, o.shape[-1] // N),
        "u": u[..., None],
        "r": data["r"][..., None],
        "padded": data["padded"][..., None],
        "terminated": data["terminated"][..., None],
    }
    if "s_ext" in data:
        views["s_ext"] = data["s_ext"]
    return views


def store(replay: ReplayState, episodes: dict) -> ReplayState:
    """Write B episodes (each array ``(B, T, ...)``) into the ring in place
    at the cursor, wrapping; returns the ring with the new cursor and
    size (the tensors are the same)."""
    episodes = _flatten_episodes(episodes)
    B = episodes["u"].shape[0]
    capacity = replay.data["u"].shape[0]
    if B > capacity:
        raise ValueError(f"a rollout of {B} episodes does not fit a replay "
                         f"ring of {capacity}")
    device = replay.data["u"].device
    idx = (replay.cursor + torch.arange(B, device=device)) % capacity
    for k, v in replay.data.items():
        v.index_copy_(0, idx, episodes[k].to(v.dtype))
    return ReplayState(data=replay.data,
                       cursor=(replay.cursor + B) % capacity,
                       size=min(replay.size + B, capacity))


def sample(replay: ReplayState, batch_size: int,
           generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None) -> dict:
    """A minibatch of ``batch_size`` episodes drawn uniformly with
    replacement from the ``max(size, 1)`` stored ones (JAX
    ``replay.sample``); ``idx`` gives the indices instead, which lets the
    tests replay the JAX package's draws."""
    device = replay.data["u"].device
    if idx is None:
        idx = torch.randint(0, max(replay.size, 1), (batch_size,),
                            generator=generator, device=device)
    idx = idx.to(device)
    return logical_views({k: v[idx] for k, v in replay.data.items()})
