"""``BENCHMARK.json`` against the contract's limits, and the harness's
discovery of cells, configurations, traffic mixes, metric readers and
limits from files."""

import json
import re

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert set(m) <= METRIC_KEYS and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(x["name"]) and 1 <= len(x["why"]) <= 200, x


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_from_files(cell):
    c = harness.find_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, cell
    assert c.traffic["mode"] in ("train", "collect")
    assert (harness.HERE / "modes" / f"{c.traffic['mode']}.py").is_file()
    for m in c.per_layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
    limits = json.loads((harness.HERE / "limits" / f"{cell}.json")
                        .read_text())
    assert limits["limits"] and all(
        v >= 0 for v in limits["limits"].values())


def test_configurations_hold_what_the_reference_needs():
    for conf in BENCH["configs"]:
        c = json.loads((harness.ROOT / conf["file"]).read_text())
        assert c["name"] == conf["name"] and c["reduced"] == conf["reduced"]
        cfg = harness.reference_config(c)
        for key in ("kind", "width", "length", "n_droplets", "fov",
                    "obs_channels", "n_actions", "conv_channels",
                    "rnn_hidden", "batch_size", "updates_per_cycle"):
            assert key in cfg, (conf["name"], key)


def test_metric_readers_return_nothing_without_a_trace():
    """Every reader, those of candidate cells' metrics too."""
    ctx = {"spans": {}, "window_s": 1.0, "window_flops": 1.0,
           "peak_flops": 1.0, "trace": None}
    readers = [p.stem for p in (harness.HERE / "metrics").glob("*.py")]
    assert {m["name"] for m in BENCH["per_layer"]} <= set(readers)
    for name in readers:
        assert harness.read_metric(name, ctx) is None, name
