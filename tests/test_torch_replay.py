"""The port's replay ring (``marl_dmfb_tpu_torch/replay.py``) against the
JAX package's: the same episodes give the same ring, cursor and size,
through a wrap of the cursor, and the same indices give the same minibatch,
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_dmfb_tpu import replay as jreplay
from marl_dmfb_tpu_torch import replay as treplay
from tests.torch_learn_util import assert_rings_equal

T, N, D = 3, 2, 4


def _episodes(rng, B):
    """B episodes in the rollout's layout, as numpy arrays."""
    return {
        "o_ext": rng.randint(-128, 128, (B, T + 1, N, D)).astype(np.int8),
        "u": rng.randint(0, 5, (B, T, N, 1)).astype(np.int32),
        "r": rng.randn(B, T, 1).astype(np.float32),
        "padded": rng.rand(B, T, 1) < 0.3,
        "terminated": rng.rand(B, T, 1) < 0.5,
    }


def test_store_and_sample_match_jax_through_a_wrap():
    rng = np.random.RandomState(0)
    jr = jreplay.init_replay(5, T, N, D, 5)
    tr = treplay.init_replay(5, T, N, D)
    for B in (3, 3, 4):          # the second and third stores wrap
        eps = _episodes(rng, B)
        jr = jreplay.store(jr, {k: jnp.asarray(v) for k, v in eps.items()})
        tr = treplay.store(tr, {k: torch.from_numpy(v)
                                for k, v in eps.items()})
        assert_rings_equal(jr, tr)
    assert tr.cursor == 0 and tr.size == 5
    key = jax.random.PRNGKey(3)
    want = jreplay.sample(jr, key, 7)
    idx = jax.random.randint(key, (7,), 0, jnp.maximum(jr.size, 1))
    got = treplay.sample(tr, 7, idx=torch.from_numpy(np.array(idx)))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.array(want[k]), got[k].numpy(), k)


def test_sample_draws_only_stored_episodes():
    tr = treplay.init_replay(8, T, N, D)
    eps = {k: torch.from_numpy(v)
           for k, v in _episodes(np.random.RandomState(1), 3).items()}
    eps["r"] = torch.full((3, T, 1), 5.0)
    tr = treplay.store(tr, eps)
    g = torch.Generator().manual_seed(0)
    batch = treplay.sample(tr, 64, generator=g)
    assert batch["o_ext"].shape == (64, T + 1, N, D)
    assert batch["u"].shape == (64, T, N, 1)
    assert bool((batch["r"] == 5.0).all())   # never an empty slot


def test_store_refuses_more_episodes_than_the_ring_holds():
    tr = treplay.init_replay(2, T, N, D)
    eps = {k: torch.from_numpy(v)
           for k, v in _episodes(np.random.RandomState(2), 3).items()}
    with pytest.raises(ValueError, match="does not fit"):
        treplay.store(tr, eps)
