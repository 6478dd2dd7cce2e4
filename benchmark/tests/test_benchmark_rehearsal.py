"""Each cell rehearsed on the CPU at a tiny size: the result line's
schema, a sound run judged correct, and the run judged not correct with
its timed path broken underneath in each way the cell can break."""

import json

import pytest
import torch

from benchmark import faults
from benchmark.calibrate import EXACT
from benchmark.tests.rehearsal import TINY, make_cell, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run(cell):
    line = run_tiny(cell)
    assert list(line) == KEYS          # the numbers compared come last
    json.dumps(line)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", (
        "actor_env_steps_per_s" if "collect" in cell
        else "train_env_steps_per_s")}, line["metrics"]
    assert line["device"]["platform"] == "cpu"
    # the cells' limits are read on the card at their own sizes; here, at
    # tiny sizes on the CPU, the exact numbers are 0 and the gaps float32
    # round-off of a small minibatch
    for name, c in line["checks"].items():
        assert c["value"] <= (0 if name in EXACT else 1e-5), (name, c)


def test_traced_line_has_only_per_layer_metrics():
    line = run_tiny("meda80.train", trace=True)
    # the CPU has no device trace: only the spans' metrics are read
    assert set(line["metrics"]) == {"learn_update_ms.train",
                                    "rollout_ms.train", "store_ms.train"}
    assert list(line)[-1] == "checks"


ONE_CARD = [c for c in sorted(TINY) if "mesh" not in c]
FAULTS = [(cell, fault) for cell in ONE_CARD
          for fault in (("answer_altered",) if "collect" in cell
                        else ("state_unchanged", "half_batch",
                              "answer_altered"))]


@pytest.mark.parametrize("fault", ["no_exchange", "state_unchanged",
                                   "half_batch", "answer_altered"])
def test_broken_mesh_run_is_not_correct(fault):
    """The fault planted in every rank of the 4-rank run."""
    line = run_tiny("dmfb10-2d.train.mesh4", plant=faults.PLANTS[fault])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    faults.PLANTS[fault](monkeypatch.setattr)
    line = run_tiny(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell, cuda):
    """The reference in TF32 in the program's place fails a limit of the
    cell, on three seeds."""
    from benchmark.checks import load_limits

    if torch.cuda.device_count() < make_cell(cell).chips:
        pytest.skip(f"{cell} needs {make_cell(cell).chips} cards")

    limits = load_limits(cell)["limits"]
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        readings = run_tiny(cell, seed=seed, device=cuda,
                            calibrate=True)["readings"]
        failed = [k for k, v in readings.items() if k.startswith("control.")
                  and v > limits.get(k.split(".", 1)[1], float("inf"))]
        assert failed, readings
    torch.cuda.empty_cache()
