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

The seed farm keeps one ring per seed as one ring with a seed axis first
(``init_replay(seeds=S)``): every seed stores B episodes a cycle, so the
seeds share the cursor and the size; :func:`store_stacked` and
:func:`sample_stacked` write and read all seeds in one operation per field.
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
                state_dim: Optional[int] = None,
                seeds: int = 0) -> ReplayState:
    """An empty ring of ``capacity`` episodes; with ``state_dim``, also
    their global states (JAX replay.py:58-107); with ``seeds`` > 0, one
    such ring per seed, stacked on a first axis."""
    S, T, N = capacity, episode_limit, n_agents
    lead = (seeds, S) if seeds else (S,)
    kw = dict(device=device)
    data = {
        "o_ext": torch.zeros((*lead, T + 1, N * obs_dim), dtype=obs_dtype,
                             **kw),
        "u": torch.zeros((*lead, T, N), dtype=torch.int8, **kw),
        "r": torch.zeros((*lead, T), dtype=torch.float32, **kw),
        "padded": torch.zeros((*lead, T), dtype=torch.bool, **kw),
        "terminated": torch.zeros((*lead, T), dtype=torch.bool, **kw),
    }
    if state_dim is not None:
        data["s_ext"] = torch.zeros((*lead, T + 1, state_dim),
                                    dtype=torch.int8, **kw)
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
    return _store(replay, _flatten_episodes(episodes), 0)


def store_stacked(replay: ReplayState, episodes: dict) -> ReplayState:
    """:func:`store` of S seeds' episodes, each array ``(S*B, T, ...)``
    seed-major, into the rings of ``init_replay(seeds=S)``: seed i's B
    episodes at the shared cursor of its ring."""
    S = replay.data["u"].shape[0]
    flat = {k: v.view(S, v.shape[0] // S, *v.shape[1:])
            for k, v in _flatten_episodes(episodes).items()}
    return _store(replay, flat, 1)


def _store(replay: ReplayState, episodes: dict, axis: int) -> ReplayState:
    """Write the episodes along ``axis`` of the ring's tensors."""
    B = episodes["u"].shape[axis]
    capacity = replay.data["u"].shape[axis]
    if B > capacity:
        raise ValueError(f"a rollout of {B} episodes does not fit a replay "
                         f"ring of {capacity}")
    device = replay.data["u"].device
    idx = (replay.cursor + torch.arange(B, device=device)) % capacity
    for k, v in replay.data.items():
        v.index_copy_(axis, idx, episodes[k].to(v.dtype))
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


def sample_stacked(replay: ReplayState, idx: torch.Tensor) -> dict:
    """The minibatches ``idx`` (S, b) of the rings of
    ``init_replay(seeds=S)``, seed i's from its ring, in the learner's
    views with the seed axis first: ``(S, b, T, N, .)``."""
    device = replay.data["u"].device
    idx = idx.to(device)
    seeds = torch.arange(idx.shape[0], device=device)[:, None]
    return logical_views({k: v[seeds, idx] for k, v in replay.data.items()})
