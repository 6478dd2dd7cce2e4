"""Tiny sizes at which each cell's run rehearses on the CPU: the same
code path, boards, batches and ring cut so that a test holds them.  The
candidate cells, whose files are ready but which are not cells of
``BENCHMARK.json`` yet (PERF.md, Open questions), rehearse too."""

import json
import time

from benchmark import harness

# candidate cells: (configuration, traffic, cards)
CANDIDATES = {
    "flagship.train": ("dmfb_20x20_4d_fov9_vdn", "train_full_ring", 1),
    "dmfb10-2d.train.mesh4": ("dmfb_10x10_2d_fov9_vdn", "train_full_ring",
                              4),
}

TINY = {
    "flagship.train": {"width": 10, "length": 10, "rollout_batch": 4,
                       "buffer_size": 32, "batch_size": 8,
                       "updates_per_cycle": 2, "lr_decay_steps": 33333},
    "flagship.collect": {"width": 10, "length": 10, "collect_chips": 64},
    "meda80.train": {"width": 45, "length": 60, "buffer_size": 16,
                     "batch_size": 4},
    "dmfb10-2d.train.mesh4": {"rollout_batch": 8, "buffer_size": 32,
                              "batch_size": 8, "updates_per_cycle": 2},
}


def make_cell(name: str) -> harness.Cell:
    """A cell of ``BENCHMARK.json``, or a candidate with the train cells'
    metrics."""
    if name not in CANDIDATES:
        return harness.find_cell(name)
    config, traffic, chips = CANDIDATES[name]
    bench = harness.load_benchmark()
    e2e = [m for m in bench["end_to_end"]
           if m["name"] in ("setup_s", "train_env_steps_per_s")]
    return harness.Cell(
        name=name,
        config=json.loads((harness.HERE / "configs" / f"{config}.json")
                          .read_text()),
        traffic=harness.load_traffic(traffic), chips=chips, end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if m["name"].endswith(".train")])


def run_tiny(cell: str, seed: int = 2**31 + 7, trace: bool = False,
             device: str = "cpu", calibrate: bool = False,
             plant=None) -> dict:
    """One run of ``cell`` at its tiny size on ``device`` (a run over
    several cards: as many gloo ranks on the CPU), with a window of a
    single cycle or rollout."""
    return harness.run(make_cell(cell), seed, 0.0, trace, device,
                       time.time(), overrides=TINY[cell],
                       calibrate=calibrate, plant=plant)
