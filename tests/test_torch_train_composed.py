"""The composed training path of the PyTorch port against the JAX
package's on the CPU: the same rollout (the JAX draws replayed), ``store``
into the replay ring, and ``learn_many`` with JAX's minibatch indices
(``keys = split(key, K)``, ``randint(keys[k], (batch,), 0, max(size, 1))``),
over two cycles, and over enough cycles to reach what a long run reaches
with the trainers' epsilon schedule and EMA
(``tests/torch_learn_util.check_composed``, ``check_long_horizon``).
Tolerances:
``tests/torch_learn_util`` (loss rtol 1e-6, params atol 1e-5 outside
float-noise gradients); the episodes, the rings and epsilon exactly."""

import numpy as np
import pytest

from tests.torch_learn_util import (QMIX, SMALL_MEDA, check_composed,
                                    check_long_horizon)


def test_rollout_store_learn_many_match_jax():
    """Two cycles of rollout -> store -> ``learn_many`` (2 updates each, a
    target sync at the second) on a ring of 6 episodes, which the second
    store wraps."""
    jr, tr, port = check_composed((("buffer_size", 6),))
    assert tr.size == 6 and tr.cursor == 2 and port.train_step == 4


# a ring of 6 episodes filled 4 a cycle; epsilon from 1 to its floor of
# 0.05 over 100 schedule steps (4 chips x 20 steps a cycle); a cosine lr
# over int(150 / (2 * 15)) = 5 updates; an EMA of 0.9 an update.  On MEDA
# 15x30 (T = 45) the same flags: epsilon at its floor within the first
# cycle, the lr over int(150 / (2 * 33)) = 2 updates, an episode a chip a
# cycle as on DMFB
LONG = (("buffer_size", 6), ("anneal_steps", 100), ("lr_decay", True),
        ("n_steps", 150), ("param_ema", 0.9))


@pytest.mark.parametrize("items,decay", [
    (LONG, 5), (LONG + QMIX, 5), (LONG + SMALL_MEDA, 2),
    (LONG + QMIX + SMALL_MEDA, 2)], ids=["vdn", "qmix", "meda", "meda_qmix"])
def test_long_horizon_matches_jax(tmp_path, items, decay):
    """Five cycles of 2 updates with the trainers' schedules: epsilon
    reaches its floor, the target syncs every 2 updates (5 syncs), the ring
    wraps three times, the lr runs past its decay horizon, and the EMA
    params follow JAX's after every cycle."""
    jr, tr, port, eps = check_long_horizon(items, 5, tmp_path)
    updates = port.train_step
    assert eps == np.float32(0.05)
    assert updates // port.args.target_update_cycle >= 2
    assert tr.size == 6 and tr.cursor == 5 * 4 % 6   # 20 episodes stored
    assert updates > port.opt.decay_steps == decay
