"""The composed training path of the PyTorch port against the JAX
package's on the CPU: the same rollout (the JAX draws replayed), ``store``
into the replay ring, and ``learn_many`` with JAX's minibatch indices
(``keys = split(key, K)``, ``randint(keys[k], (batch,), 0, max(size, 1))``),
over two cycles (``tests/torch_learn_util.check_composed``).  Tolerances:
``tests/torch_learn_util`` (loss rtol 1e-6, params atol 1e-5 outside
float-noise gradients); the episodes and the rings exactly."""

from tests.torch_learn_util import check_composed


def test_rollout_store_learn_many_match_jax():
    """Two cycles of rollout -> store -> ``learn_many`` (2 updates each, a
    target sync at the second) on a ring of 6 episodes, which the second
    store wraps."""
    jr, tr, port = check_composed((("buffer_size", 6),))
    assert tr.size == 6 and tr.cursor == 2 and port.train_step == 4
