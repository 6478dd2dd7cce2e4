"""The port's optimizer step (``algos/qlearn.py:Optimizer``) against
optax's: RMS, SGD and the cosine learning-rate decay through whole learner
updates (tolerances of ``tests/torch_learn_util``), and the clip and the
schedule alone against optax's functions."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marl_dmfb_tpu_torch.algos.qlearn import Optimizer, make_optimizer
from tests.torch_learn_util import check_updates, jax_learner


@pytest.mark.parametrize("items", [
    (("optimizer", "RMS"),),
    (("optimizer", "SGD"),),
    (("optimizer", "RMS"), ("lr_decay", True), ("n_steps", 60)),
], ids=["rms", "sgd", "rms_lr_decay"])
def test_optimizer_updates_match_jax(items):
    check_updates(items, n=3)


def test_lr_decay_updates_match_jax_past_the_decay():
    """Adam with ``--lr_decay`` over 5 updates of a 2-update schedule: the
    rate falls, then stays at 5% of lr."""
    items = (("lr_decay", True), ("n_steps", 60))
    assert make_optimizer(jax_learner(items).ta).decay_steps == 2
    check_updates(items, n=5)


@pytest.mark.parametrize("decay_steps", [1, 7, 1000])
def test_schedule_matches_optax(decay_steps):
    opt = Optimizer("ADAM", 5e-4, 9.0, decay_steps)
    sched = optax.cosine_decay_schedule(5e-4, decay_steps, alpha=0.05)
    for count in list(range(0, 12)) + [decay_steps - 1, decay_steps,
                                       decay_steps + 1, 5 * decay_steps]:
        want = float(sched(jnp.int32(max(count, 0))))
        # float32 throughout; cos may round an ulp apart
        assert float(opt.learning_rate(max(count, 0))) == pytest.approx(
            want, rel=1e-6, abs=0), count


@pytest.mark.parametrize("scale", [0.1, 1.0, 30.0],
                         ids=["below", "near", "above"])
def test_clip_matches_optax(scale):
    """One SGD step with lr 1 returns minus the clipped gradient."""
    rng = np.random.RandomState(int(scale * 10))
    grads = {"a": rng.randn(3, 4).astype(np.float32) * scale,
             "b": rng.randn(5).astype(np.float32) * scale}
    want, _ = optax.clip_by_global_norm(9.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    params = {k: torch.zeros(v.shape) for k, v in grads.items()}
    opt = Optimizer("SGD", 1.0, 9.0)
    opt.step(params, {k: torch.from_numpy(v) for k, v in grads.items()},
             opt.init(params))
    for k in grads:
        np.testing.assert_allclose(-params[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
