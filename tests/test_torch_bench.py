"""The port's measuring entry points (``marl_dmfb_tpu_torch.bench``,
``.bench_train``, ``.bench_scaling``, ``.bench_multiproc``) on the CPU at
small sizes: each runs through its ``main(argv)`` under ``--device cpu``
and prints JAX's lines (``metric``, ``value``, ``unit``, ``vs_baseline``)
with finite positive values and no TPU in a unit; the analytic FLOP count,
the updates a cycle and the parameter bytes of the collectives equal the
JAX scripts'; and without a card the default ``--device cuda`` raises.

The training benchmarks run the CLI's configuration with narrow nets
(``make_args`` wrapped: batch 8, ring 32, 8 conv channels, GRU 16) and one
timed cycle; the rank benchmarks run at most 2 gloo ranks."""

import json
import math

import pytest
import torch

import bench_multiproc as jbench_multiproc
import bench_train as jbench_train
from marl_dmfb_tpu import config as jconfig
from marl_dmfb_tpu_torch import (bench, bench_multiproc, bench_scaling,
                                 bench_train)
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch.trainer import Trainer, updates_per_rollout

torch.set_num_threads(1)


def _narrow(make_args):
    def small(*a, **kw):
        args = make_args(*a, **kw)
        args.batch_size, args.buffer_size = 8, 32
        args.hyper_hidden_dim, args.rnn_hidden_dim = 8, 16
        return args

    return small


def _lines(capsys, returned):
    """The JSON lines printed, which are those returned."""
    out = capsys.readouterr().out
    printed = [json.loads(line) for line in out.splitlines()
               if line.startswith("{")]
    returned = returned if isinstance(returned, list) else [returned]
    assert printed == returned
    return {line["metric"] if "config" not in line
            else f"{line['metric']}:{line['config']}": line
            for line in printed}


def _check(line, vs_baseline_null=True):
    assert set(line) >= {"metric", "value", "unit", "vs_baseline"}
    assert isinstance(line["value"], (int, float))
    assert math.isfinite(line["value"]) and line["value"] > 0, line
    unit = line["unit"].lower()
    assert "tpu" not in unit and "v5e" not in unit, line["unit"]
    if vs_baseline_null:
        assert line["vs_baseline"] is None, line


@pytest.mark.parametrize("argv,metric", [
    (["8"], "actor_env_steps_per_sec"),
    (["4", "0", "meda"], "actor_env_steps_per_sec_meda"),
    (["8", "2", "dmfb", "bf16"], "actor_env_steps_per_sec_blocks2_bf16"),
], ids=["dmfb", "meda", "blocks-bf16"])
def test_actor_bench(capsys, argv, metric):
    lines = _lines(capsys, bench.main([*argv, "--device=cpu"], iters=2))
    assert list(lines) == [metric]
    _check(lines[metric])
    assert lines[metric]["unit"] == "env-steps/s"


def test_actor_bench_meda_with_blocks_exits():
    with pytest.raises(SystemExit, match="n_blocks must be 0"):
        bench.main(["4", "2", "meda", "--device=cpu"])


def test_train_bench(capsys, monkeypatch):
    monkeypatch.setattr(bench_train, "make_args",
                        _narrow(bench_train.make_args))
    lines = _lines(capsys, bench_train.main(["8", "--device=cpu"],
                                            learn_iters=2, cycles=1))
    # the last line reads the committed artifact of the port's training to
    # quality (tests/test_torch_time_to_quality.py holds it)
    assert list(lines) == ["learn_step_ms", "learn_step_tflops",
                           "train_loop_env_steps_per_sec", "train_e2e",
                           "time_to_quality_recorded"]
    for name, line in lines.items():
        _check(line, vs_baseline_null=name != "learn_step_tflops")
    tflops = lines["learn_step_tflops"]
    assert tflops["vs_baseline"] == pytest.approx(
        tflops["value"] * 1e12 / bench_train.PEAK_F32_FLOPS)
    assert "67 TFLOP/s" in tflops["unit"]
    # B = 8 episodes a cycle at the 4-droplet YAML's n_episodes = 2
    assert "(4 updates per 8-episode rollout)" in lines["train_e2e"]["unit"]
    assert (lines["train_e2e"]["value"]
            == lines["train_loop_env_steps_per_sec"]["value"])


def _arg_pair(name, **kw):
    ja = jconfig.Args(name=name, **kw)
    ta = tconfig.Args(name=name, device="cpu", **kw)
    ja.apply_env_defaults()
    ja.load_yaml()
    ta.apply_env_defaults()
    ta.load_hparams()
    ja.update_env_info(jconfig.make_env_from_args(ja).env_info())
    ta.update_env_info(tconfig.make_env_from_args(ta).env_info())
    return ja, ta


@pytest.mark.parametrize("last_action", [True, False], ids=["last", "no-last"])
@pytest.mark.parametrize("name,kw", [
    ("dmfb", dict(drop_num=2, fov=5, width=5, length=5)),
    ("dmfb", dict(drop_num=4, fov=9, width=10, length=10)),
    ("meda", dict(drop_num=4, fov=19)),
], ids=["dmfb-fov5", "dmfb-fov9", "meda-fov19"])
def test_learn_flops_equal_jax(name, kw, last_action):
    ja, ta = _arg_pair(name, last_action=last_action, **kw)
    assert (bench_train.estimate_learn_flops(ta)
            == jbench_train.estimate_learn_flops(ja))


@pytest.mark.parametrize("name,drop_num", [("dmfb", 4), ("dmfb", 2),
                                           ("meda", 4), ("meda", 3)])
def test_updates_per_cycle_equal_jax(name, drop_num):
    """JAX's ``max(1, round(train_time * B / n_episodes))``
    (``bench_train.py:74``, ``bench_multiproc.py:78``), and the trainer's."""
    ja, ta = _arg_pair(name, drop_num=drop_num)
    for B in (1, 2, 3, 5, 7, 8, 32, 64, 1000, 1024, 16384):
        want = max(1, round(ja.train_time * B / ja.n_episodes))
        assert updates_per_rollout(ta, B) == want, B
    ta = _arg_pair("dmfb", drop_num=2, fov=5, width=5, length=5)[1]
    ta.n_parallel_envs, ta.evaluate_task = 7, 2
    trainer = Trainer(tconfig.make_env_from_args(ta), ta)
    assert trainer.updates_per_rollout == updates_per_rollout(ta, 7)


def test_collective_param_bytes_equal_jax():
    """The gradient ``all_reduce`` carries JAX's ``grad_psum_bytes`` of
    parameters (and the loss's two float32 sums); the minibatch is JAX's,
    and so is an episode's bytes, but for the float32 observations of
    JAX's MEDA row (its ``make_env`` default, v0), which JAX's formula
    counts at one byte a value; the global ring's gather moves every
    row."""
    want = jbench_multiproc.bytes_per_update()
    got = bench_multiproc.collective_bytes()
    assert [r["config"] for r in got] == [r["config"] for r in want]
    for g, w in zip(got, want):
        assert g["param_bytes"] == w["grad_psum_bytes"], g["config"]
        assert g["grad_all_reduce_bytes"] == w["grad_psum_bytes"] + 8
        assert g["batch_size"] == w["batch_size"]
    assert got[0]["episode_bytes"] == want[0]["episode_bytes"]
    T, N, obs = 90, 4, 4 * 19 * 19 + 2       # MEDA 30x60-4d, fov 19, v0
    assert got[1]["episode_bytes"] == (want[1]["episode_bytes"]
                                       + 3 * (T + 1) * N * obs)
    for g in got:
        assert g["replay_gather_bytes_global"] == (
            g["batch_size"] * g["episode_bytes"])
        assert g["replay_gather_bytes_local"] == 0


def test_scaling_bench(capsys, monkeypatch):
    monkeypatch.setattr(bench_scaling, "visible_devices", lambda device: 2)
    lines = _lines(capsys, bench_scaling.main(["4", "--device=cpu"],
                                              iters=1))
    assert list(lines) == ["actor_env_steps_per_sec_1dev",
                           "actor_env_steps_per_sec_2dev",
                           "sharding_overhead_ratio_2dev"]
    for line in lines.values():
        _check(line, vs_baseline_null=False)
    assert lines["actor_env_steps_per_sec_1dev"]["vs_baseline"] == 1.0
    two = lines["actor_env_steps_per_sec_2dev"]
    one = lines["actor_env_steps_per_sec_1dev"]
    assert two["vs_baseline"] == pytest.approx(two["value"]
                                               / (2 * one["value"]))
    ratio = lines["sharding_overhead_ratio_2dev"]
    assert ratio["vs_baseline"] == ratio["value"]


def test_multiproc_bench(capsys, monkeypatch):
    monkeypatch.setattr(bench_multiproc, "make_args",
                        _narrow(bench_multiproc.make_args))
    monkeypatch.setattr(bench_multiproc, "visible_devices",
                        lambda device: 2)
    out = bench_multiproc.main(["--device=cpu"], cycles=1)
    assert "train_cycle_s_4rank left out" in capsys.readouterr().err
    printed = {line["metric"] + line.get("config", ""): line for line in out}
    cycles = ["train_cycle_s_1rank", "train_cycle_s_2rank",
              "train_cycle_s_2rank_local_sampling"]
    for name in cycles:
        _check(printed[name], vs_baseline_null=False)
        assert "6 updates a cycle" in printed[name]["unit"]
    eff = printed["multiproc_efficiency"]
    _check(eff)
    assert eff["value"] == pytest.approx(
        printed["train_cycle_s_1rank"]["value"]
        / printed["train_cycle_s_2rank"]["value"])
    assert printed["train_cycle_s_2rank_local_sampling"]["vs_baseline"] > 0
    assert [line["metric"] for line in out].count(
        "collective_bytes_per_update") == 2


@pytest.mark.parametrize("module", [bench, bench_train, bench_scaling,
                                    bench_multiproc],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_device_is_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])


def test_updates_and_rounding_under_local_sampling():
    """JAX rounds the minibatch down to tile the devices under
    ``--local_sampling`` (``bench_multiproc.py:60-61``)."""
    for n, local, want in ((1, False, 128), (2, True, 128), (3, True, 126),
                           (4, False, 128)):
        args = bench_multiproc.make_args("cpu", n, local)
        assert (args.batch_size, args.rollout_batch) == (want, 32)
    assert bench_multiproc.TOTAL_B == jbench_multiproc.TOTAL_B
    assert bench_multiproc.CYCLES == jbench_multiproc.CYCLES
