"""The cells ``meda80-qmix.train`` and ``meda80.collect`` rehearsed on the
CPU at a tiny size (the same code path, the board cut to 45x60 and the
ring, the minibatch and the collection's batch cut so that a test holds
them), as ``benchmark/tests/test_benchmark_rehearsal.py`` rehearses the
others: the result line's schema, a sound run judged correct under the
cells' limits, and the run judged not correct with its timed path broken
underneath, by the faults of ``benchmark/faults.py`` and by faults of the
QMIX path's own: the eval mix fed the next step's states, a global state
altered in the rollout, in the ring and in a minibatch, and the
optimizer's step taken against the gradient.  Also the
mixer's FLOPs by hand and the new metric readers' arithmetic.

On a card (``cuda``-marked, run with ``--noconftest``): the control (the
reference in TF32 in the program's place) fails a limit of each cell.
"""

import json
import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.calibrate import EXACT
from benchmark.checks import load_limits

torch.set_num_threads(2)

QMIX_CELL, COLLECT_CELL = "meda80-qmix.train", "meda80.collect"
TINY = {QMIX_CELL: {"width": 45, "length": 60, "buffer_size": 16,
                    "batch_size": 4, "state_dim": 2 * 45 * 60},
        COLLECT_CELL: {"width": 45, "length": 60, "collect_chips": 64}}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run_tiny(cell: str, seed: int = 2**31 + 7, trace: bool = False,
             device: str = "cpu", calibrate: bool = False) -> dict:
    """One run of ``cell`` at its tiny size, with a window of a single
    cycle or rollout."""
    return harness.run(harness.find_cell(cell), seed, 0.0, trace, device,
                       time.time(), overrides=TINY[cell],
                       calibrate=calibrate)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    line = run_tiny(cell)
    assert list(line) == KEYS          # the numbers compared come last
    json.dumps(line)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", (
        "actor_env_steps_per_s" if "collect" in cell
        else "train_env_steps_per_s")}, line["metrics"]
    assert line["device"]["platform"] == "cpu"
    assert line["correct"], line["checks"]
    # at tiny sizes on the CPU the exact numbers are 0 and the gaps
    # float32 round-off of a small minibatch
    for name, c in line["checks"].items():
        assert c["value"] <= (0 if name in EXACT else 1e-5), (name, c)
    if cell == QMIX_CELL:
        assert {"rollout_mismatch", "replay_mismatch", "loss_gap",
                "grad_gap", "delta_gap", "step_gap"} <= set(line["checks"])


def test_traced_line_reads_the_spans():
    line = run_tiny(QMIX_CELL, trace=True)
    # the CPU has no device trace: only the benchmark's spans are read
    assert set(line["metrics"]) == {"learn_update_ms.train",
                                    "rollout_ms.train", "store_ms.train"}
    assert list(line)[-1] == "checks"


class _OnNextStates(torch.nn.Module):
    """A mixer fed ``s_next`` whatever states it is given."""

    def __init__(self, mixer, s_next):
        super().__init__()
        self.mixer, self.s_next = mixer, s_next

    def forward(self, q, states):
        return self.mixer(q, self.s_next)


def eval_mix_on_next_states(set_attr):
    """The eval mix fed ``s_ext[:, 1:]``, the target mix's states."""
    from marl_dmfb_tpu_torch.algos import qlearn

    real = qlearn.TDLoss.td_sums

    def td_sums(self, batch):
        mixer = self.mixer
        self.mixer = _OnNextStates(mixer, batch["s_ext"].float()[:, 1:])
        try:
            return real(self, batch)
        finally:
            self.mixer = mixer

    set_attr(qlearn.TDLoss, "td_sums", td_sums)


def rollout_state_altered(set_attr):
    """One cell of every global state the env gives, changed."""
    from marl_dmfb_tpu_torch.envs import meda

    real = meda.global_state

    def global_state(params, state):
        s = real(params, state).clone()
        s[0, 0] += 1
        return s

    set_attr(meda, "global_state", global_state)


def ring_state_altered(set_attr):
    """One state element of each store's first episode, changed in the
    ring after the write."""
    from marl_dmfb_tpu_torch import replay

    real = replay._store

    def _store(ring, episodes, axis):
        out = real(ring, episodes, axis)
        out.data["s_ext"][ring.cursor, 0, 0] += 1
        return out

    set_attr(replay, "_store", _store)


def minibatch_state_altered(set_attr):
    """One state element of each minibatch, changed after the gather."""
    from marl_dmfb_tpu_torch.algos import qlearn

    real = qlearn.sample

    def sample(*args, **kwargs):
        batch = dict(real(*args, **kwargs))
        batch["s_ext"] = batch["s_ext"].clone()
        batch["s_ext"][0, 0, 0] += 1
        return batch

    set_attr(qlearn, "sample", sample)


def step_sign_flipped(set_attr):
    """Each optimizer step taken against the gradient: the same size, the
    other direction."""
    from marl_dmfb_tpu_torch.algos import qlearn

    real = qlearn.Optimizer.step

    @torch.no_grad()
    def step(self, params, grads, state, stacked=False):
        before = {k: p.clone() for k, p in params.items()}
        state = real(self, params, grads, state, stacked)
        for k, p in params.items():
            p.copy_(2 * before[k] - p)
        return state

    set_attr(qlearn.Optimizer, "step", step)


QMIX_FAULTS = {"eval_mix_on_next_states": eval_mix_on_next_states,
               "rollout_state_altered": rollout_state_altered,
               "ring_state_altered": ring_state_altered,
               "minibatch_state_altered": minibatch_state_altered,
               "step_sign_flipped": step_sign_flipped}
# (cell, fault, a number it must put over its limit)
FAULTS = [
    (QMIX_CELL, "half_batch", "loss_gap"),
    (QMIX_CELL, "answer_altered", "rollout_mismatch"),
    (QMIX_CELL, "eval_mix_on_next_states", "loss_gap"),
    (QMIX_CELL, "rollout_state_altered", "rollout_mismatch"),
    (QMIX_CELL, "ring_state_altered", "replay_mismatch"),
    (QMIX_CELL, "minibatch_state_altered", "replay_mismatch"),
    (QMIX_CELL, "step_sign_flipped", "step_gap"),
    (COLLECT_CELL, "answer_altered", "rollout_mismatch"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS)
def test_broken_run_is_not_correct(cell, fault, number, monkeypatch):
    plant = QMIX_FAULTS.get(fault) or faults.PLANTS[fault]
    plant(monkeypatch.setattr)
    line = run_tiny(cell)
    assert not line["correct"], line["checks"]
    c = line["checks"][number]
    assert c["limit"] is not None and c["value"] > c["limit"], (number, c)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    """The reference in TF32 in the program's place fails a limit of the
    cell, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists on the card only")
    limits = load_limits(cell)["limits"]
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        readings = run_tiny(cell, seed=seed, device="cuda",
                            calibrate=True)["readings"]
        failed = [k for k, v in readings.items() if k.startswith("control.")
                  and v > limits.get(k.split(".", 1)[1], float("inf"))]
        assert failed, readings
    torch.cuda.empty_cache()


def test_mixer_flops_by_hand():
    from benchmark import flops, flops_qmix

    cell = harness.find_cell(QMIX_CELL)
    cfg = {**cell.config["mixer"], **harness.reference_config(cell.config)}
    # four hyper layers of 12800 -> 32, then 32 -> 10 x 32 and 32 -> 32,
    # the second bias layer's 32 -> 1, q^T w1 over 10 x 32, h w2 over 32
    hand = 2 * (4 * 12800 * 32 + 32 * 320 + 32 * 32 + 32 + 10 * 32 + 32)
    assert hand == 3_300_096
    assert flops_qmix.mix_row_flops(cfg) == hand
    cfg1 = {**cfg, "two_hyper_layers": False}
    assert flops_qmix.mix_row_flops(cfg1) == 2 * (
        12800 * 320 + 12800 * 32 + 2 * 12800 * 32 + 32 + 10 * 32 + 32)
    assert flops_qmix.update_flops(cfg, 160) == (
        flops.update_flops(cfg, 160) + 3 * hand * 128 * 160)
    assert flops_qmix.cycle_flops(cfg, 2, 160) == (
        flops.rollout_flops(cfg, 2, 160)
        + 2 * flops_qmix.update_flops(cfg, 160))


def test_mixer_metrics_read_the_spans(monkeypatch):
    """The readers' arithmetic on a stand-in summary of the program's
    spans and counters."""
    from marl_dmfb_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "summary", lambda: {
        "spans": {"learn.mix": {"calls": 4, "device_ms": 20.0,
                                "host_ms": 1.0},
                  "rollout.state": {"calls": 161, "host_ms": 80.5,
                                    "device_ms": 3.0}},
        "counters": {"learn.mix.rows": 4 * 2 * 128 * 160}, "cycles": 2})
    ctx = {"trace": {}, "mix_row_flops": 3_300_096.0, "peak_flops": 67e12}
    assert harness.read_metric("mix_device_ms.qmix", ctx) == 5.0
    assert harness.read_metric("state_ms.qmix", ctx) == 0.5
    want = 100 * 4 * 2 * 128 * 160 * 3_300_096 / 67e12 / 0.020
    assert harness.read_metric("mix_roofline.qmix", ctx) == pytest.approx(
        want)
    assert 0 < want < 100
    for name in ("mix_device_ms.qmix", "mix_roofline.qmix",
                 "state_ms.qmix"):
        assert harness.read_metric(name, {**ctx, "trace": None}) is None
