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

Under a mesh of n ranks (``parallel/mesh.py``) each rank holds C/n rows of
a ring of C episodes, and the cursor and the size stay global, the same on
every rank.  Two pairings, which must not be mixed (JAX ``replay.py:137-161``):

* the global ring (:func:`store` and :func:`sample` with ``mesh``): rank r
  holds rows ``[r*C/n, (r+1)*C/n)`` of the one-device ring.  A store
  gathers the cycle's B episodes and each rank writes the ring rows it
  holds; a minibatch's indices are drawn alike on every rank over the whole
  ring, and rank r gathers its share of them from wherever they live;
* local rings (:func:`store_local` and :func:`sample_local`,
  ``--local_sampling``): each rank's C/n rows are a ring of their own,
  written with its own B/n episodes at the shared cursor ``cursor // n``,
  and a rank draws its b/n indices from its own rows, with a stream of its
  own; no episode leaves its rank.

Each store, of any of the three forms, is the span ``store``
(``utils/tracing.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from marl_dmfb_tpu_torch.parallel.mesh import Mesh, gather_rows, gather_shards
from marl_dmfb_tpu_torch.utils import tracing


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


def store(replay: ReplayState, episodes: dict,
          mesh: Optional[Mesh] = None) -> ReplayState:
    """Write B episodes (each array ``(B, T, ...)``) into the ring in place
    at the cursor, wrapping; returns the ring with the new cursor and
    size (the tensors are the same).  Under ``mesh`` the ring is this
    rank's rows of the global ring and ``episodes`` this rank's rows of the
    cycle's: they are gathered, and the rank writes the ring rows it
    holds."""
    with tracing.span("store"):
        flat = _flatten_episodes(episodes)
        if mesh is None:
            return _store(replay, flat, 0)
        cap_l = replay.data["u"].shape[0]
        capacity = cap_l * mesh.size
        b_l = flat["u"].shape[0]
        B = b_l * mesh.size
        if B > capacity:
            raise ValueError(f"a rollout of {B} episodes does not fit a "
                             f"replay ring of {capacity}")
        device = flat["u"].device
        glob = gather_shards(mesh, flat)
        pos = (replay.cursor + torch.arange(B, device=device)) % capacity
        mine = (pos // cap_l) == mesh.rank
        rows = pos[mine] % cap_l
        for k, v in replay.data.items():
            v.index_copy_(0, rows, glob[k][mine].to(v.dtype))
        return ReplayState(data=replay.data,
                           cursor=(replay.cursor + B) % capacity,
                           size=min(replay.size + B, capacity))


def store_local(replay: ReplayState, episodes: dict,
                mesh: Mesh) -> ReplayState:
    """``--local_sampling``'s store (JAX ``make_local_store``): this rank's
    B/n episodes go into its own ring of C/n rows at ``cursor // n``; the
    global cursor and size advance by B.  No episode leaves the rank."""
    with tracing.span("store"):
        flat = _flatten_episodes(episodes)
        cap_l = replay.data["u"].shape[0]
        capacity = cap_l * mesh.size
        b_l = flat["u"].shape[0]
        device = flat["u"].device
        rows = (replay.cursor // mesh.size
                + torch.arange(b_l, device=device)) % cap_l
        for k, v in replay.data.items():
            v.index_copy_(0, rows, flat[k].to(v.dtype))
        B = b_l * mesh.size
        return ReplayState(data=replay.data,
                           cursor=(replay.cursor + B) % capacity,
                           size=min(replay.size + B, capacity))


def store_stacked(replay: ReplayState, episodes: dict) -> ReplayState:
    """:func:`store` of S seeds' episodes, each array ``(S*B, T, ...)``
    seed-major, into the rings of ``init_replay(seeds=S)``: seed i's B
    episodes at the shared cursor of its ring."""
    with tracing.span("store"):
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
           idx: Optional[torch.Tensor] = None,
           mesh: Optional[Mesh] = None) -> dict:
    """A minibatch of ``batch_size`` episodes drawn uniformly with
    replacement from the ``max(size, 1)`` stored ones (JAX
    ``replay.sample``); ``idx`` gives the indices instead, which lets the
    tests replay the JAX package's draws.  Under ``mesh`` (a global ring,
    this rank's rows of it) the indices are the whole minibatch's, drawn
    alike on every rank, and the rank gets its share of them,
    ``mesh.rows(batch_size)``, gathered from the ranks that hold them."""
    device = replay.data["u"].device
    if idx is None:
        idx = torch.randint(0, max(replay.size, 1), (batch_size,),
                            generator=generator, device=device)
    idx = idx.to(device)
    if mesh is None:
        return logical_views({k: v[idx] for k, v in replay.data.items()})
    cap_l = replay.data["u"].shape[0]
    owned = (idx // cap_l) == mesh.rank
    local = idx % cap_l
    rows = gather_rows(mesh, {k: v[local] for k, v in replay.data.items()},
                       owned)
    mine = mesh.rows(idx.shape[0])
    return logical_views({k: v[mine] for k, v in rows.items()})


def sample_local(replay: ReplayState, batch_size: int, mesh: Mesh,
                 generator: Optional[torch.Generator] = None,
                 idx: Optional[torch.Tensor] = None) -> dict:
    """``--local_sampling``'s minibatch share (JAX ``make_local_sample``):
    ``batch_size / n`` episodes of this rank's own ring, drawn from its
    ``clip(size // n, 1, C/n)`` written rows with ``generator``, this
    rank's stream; ``idx`` gives them instead."""
    if batch_size % mesh.size:
        raise ValueError(f"local sampling: batch_size ({batch_size}) must "
                         f"tile the {mesh.size}-device mesh")
    device = replay.data["u"].device
    cap_l = replay.data["u"].shape[0]
    if idx is None:
        local_size = min(max(replay.size // mesh.size, 1), cap_l)
        idx = torch.randint(0, local_size, (batch_size // mesh.size,),
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
