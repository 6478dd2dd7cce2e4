"""Faults planted in the program, to read what a broken timed path gives
(``calibrate.py --plant``) and to see it judged not correct (the tests).
Each is a module-level function that patches the program in the process
that calls it, as every rank of a run over several cards does first;
``set_attr`` (a test's ``monkeypatch.setattr``) undoes it afterwards."""

from __future__ import annotations


def no_exchange(set_attr=setattr):
    """The learner's exchange between the ranks left out: each rank steps
    on its own share of the minibatch's gradients and sums."""
    from marl_dmfb_tpu_torch.algos import qlearn

    set_attr(qlearn, "all_reduce_sum", lambda mesh, x: x)


def state_unchanged(set_attr=setattr):
    """The optimizer's step returns its state and leaves the weights."""
    from marl_dmfb_tpu_torch.algos import qlearn

    set_attr(qlearn.Optimizer, "step",
             lambda self, params, grads, state, stacked=False: state)


def half_batch(set_attr=setattr):
    """Each update's loss and gradients taken over the first half of its
    minibatch."""
    from marl_dmfb_tpu_torch.algos import qlearn

    real = qlearn.QLearner.loss_and_grads
    set_attr(qlearn.QLearner, "loss_and_grads", lambda self, batch: real(
        self, {k: v[: v.shape[0] // 2] for k, v in batch.items()}))


def answer_altered(set_attr=setattr):
    """One element of each step's observations changed where the env step
    produces it (the DMFB kernel's wrapper and the MEDA step)."""
    from marl_dmfb_tpu_torch.envs import meda
    from marl_dmfb_tpu_torch.ops import dmfb_step

    def altered(real):
        def step(*args):
            state, out = real(*args)
            obs = out.obs.clone()
            obs[0, 0, 0] += 1
            return state, out._replace(obs=obs)
        return step

    set_attr(dmfb_step, "step_batch", altered(dmfb_step.step_batch))
    set_attr(meda, "step_core", altered(meda.step_core))


PLANTS = {f.__name__: f for f in (no_exchange, state_unchanged, half_batch,
                                  answer_altered)}
