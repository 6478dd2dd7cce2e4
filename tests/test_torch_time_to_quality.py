"""The port's time-to-quality tool (``tools/time_to_quality_torch.py``)
and ``bench_train``'s ``time_to_quality_recorded`` line, on the CPU.

* The tool's fold, fed the success rates and wall times of the JAX
  package's committed ``artifacts/time_to_quality.json``, gives that file's
  own checkpoints, ``first_crossing`` and ``total_run`` for each entry.
* A training of a few cycles at 5x5, scored at 5x5, writes an artifact with
  JAX's keys; run again on a run directory whose run stopped early, the
  tool resumes it and adds up the training's time over both runs.
* ``bench_train`` reads the line from an artifact, with the ``metric`` and
  ``vs_baseline`` of JAX's line, and gives none without one.
"""

import importlib.util
import inspect
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bench_train as jbench_train
from marl_dmfb_tpu_torch import bench_train, checkpoint
from marl_dmfb_tpu_torch.algos.qlearn import make_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_ARTIFACT = ROOT / "artifacts" / "time_to_quality.json"
# a 5x5 board, 2 droplets, fov 5, 8 chips a rollout, a ring of 32, batches
# of 8: 1,200 env steps, a checkpoint every 400
SMALL = ["--chip_size=5", "--drop_num=2", "--fov=5", "--exact_steps=1200",
         "--evaluate_cycle=400", "--buffer_size=32", "--batch_size=8",
         "--n_parallel_envs=8"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "time_to_quality_torch", ROOT / "tools" / "time_to_quality_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ttq = _tool()


@pytest.fixture(scope="module")
def jax_artifact():
    with open(JAX_ARTIFACT) as f:
        return json.load(f)


@pytest.mark.parametrize("entry,key", [
    (None, "success_50x50"), ("meda_30x60_3d", "success"),
    ("meda_30x60_4d_attempt", "success"), ("meda_30x60_4d_long", "success")],
    ids=["flagship", "meda_30x60_3d", "meda_30x60_4d_attempt",
         "meda_30x60_4d_long"])
def test_fold_gives_jax_first_crossing(jax_artifact, entry, key):
    want = jax_artifact if entry is None else jax_artifact[entry]
    rows = want["checkpoints"]
    got = ttq.fold([c[key] for c in rows], [c["wall_s"] for c in rows],
                   first_tag=int(rows[0]["tag"]),
                   total_steps=rows[-1]["env_steps"], key=key)
    assert got["checkpoints"] == rows
    assert got["quality_bar"] == want["quality_bar"] == ttq.QUALITY_BAR
    assert got["total_run"] == want["total_run"]
    first = want["first_crossing"]
    if first is None:
        assert got["first_crossing"] is None
    else:
        assert {k: got["first_crossing"][k] for k in first} == first
    if entry is None:   # the flagship: 450k env steps, 0.99, 69.7 s
        assert (first["env_steps"], first[key], first["wall_s"]) == (
            450000, 0.99, 69.7)
    elif entry == "meda_30x60_3d":
        assert first["env_steps"] == 500000


def _cut(m, recipe="flagship", boards=()):
    """Patch, through the monkeypatch ``m``, the boards on which every
    checkpoint of ``recipe`` is also scored: a run cut to SMALL is scored
    on 5x5 alone (``--score_board``), without the flagship's 10x10 and
    20x20 (their case is ``recipe_runs``')."""
    m.setitem(ttq.RECIPES, recipe, ttq.RECIPES[recipe]._replace(
        boards=boards))


def _run(tmp, *extra):
    with pytest.MonkeyPatch.context() as m:
        _cut(m)
        return ttq.main(["--seed=3", f"--run_dir={tmp / 'run'}",
                         "--device=cpu", f"--out={tmp / 'ttq.json'}",
                         "--score_board=5", *extra, "--extra", *SMALL])


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ttq")
    torch.manual_seed(0)
    return tmp, _run(tmp)


def test_small_run_writes_jax_keys(small_run, jax_artifact):
    tmp, entry = small_run
    with open(tmp / "ttq.json") as f:
        written = json.load(f)
    flagship = {k for k, v in jax_artifact.items()
                if k in ("checkpoints", "description", "first_crossing",
                         "quality_bar", "total_run")}
    assert flagship <= set(written) and written == json.loads(
        json.dumps(entry))
    assert [c["tag"] for c in entry["checkpoints"]] == ["0", "1", "2",
                                                        "final"]
    assert [c["env_steps"] for c in entry["checkpoints"]] == [0, 400, 800,
                                                              1200]
    for c in entry["checkpoints"]:
        assert set(c) == set(jax_artifact["checkpoints"][0])
        assert 0.0 <= c["success_50x50"] <= 1.0
    walls = [c["wall_s"] for c in entry["checkpoints"]]
    assert walls == sorted(walls) and walls[-1] > 0
    assert set(entry["total_run"]) == set(jax_artifact["total_run"])
    assert "--seed=3" in entry["description"]
    assert "--lr_decay --param_ema=0.999" in entry["description"]
    assert entry["card"] in entry["description"]
    assert "resumed_at" not in entry
    # the scores are the evaluate entry point's, one a checkpoint
    with open(tmp / "run" / "scores.json") as f:
        assert list(json.load(f)) == ["0_0", "0_1", "0_2", "0_final"]


def test_second_seed_nests_and_deploy_export_loads(small_run, monkeypatch):
    tmp, entry = small_run
    shutil.copytree(tmp / "run", tmp / "run1")
    _cut(monkeypatch)
    ttq.main(["--seed=3", f"--run_dir={tmp / 'run1'}", "--device=cpu",
              f"--out={tmp / 'ttq.json'}", "--score_board=5",
              "--key=seed_1_replication", "--extra", *SMALL])
    with open(tmp / "ttq.json") as f:
        written = json.load(f)
    nested = written["seed_1_replication"]
    assert nested["note"] == "same recipe, --seed=3"
    assert nested["checkpoints"] == entry["checkpoints"]
    assert written["first_crossing"] == entry["first_crossing"]
    # the deploy export holds the final checkpoint's EMA params
    final = checkpoint.load(str(tmp / "run" / "model" / "vdn" / "fov5" /
                                "0_final_state.pt"))
    deploy = checkpoint.load(str(tmp / "run" / "deploy" / "model" / "vdn" /
                                 "fov5" / "0_final_state.pt"))
    assert set(deploy) == {"ema", "epsilon", "net_config"}
    for k, v in final["ema"]["agent"].items():
        assert torch.equal(deploy["ema"]["agent"][k], v), k


def test_stopped_run_resumes(small_run, tmp_path, monkeypatch):
    """A run stopped after its checkpoint 1 (its later checkpoints and
    times gone) resumes from it as run 1 of the remaining 800 env steps,
    with the whole run's learning-rate schedule; the artifact adds run 0's
    time up to checkpoint 1 to run 1's."""
    src, _ = small_run
    _cut(monkeypatch)
    shutil.copytree(src / "run", tmp_path / "run")
    model = tmp_path / "run" / "model" / "vdn" / "fov5"
    for tag in ("2", "final"):
        os.remove(model / f"0_{tag}_state.pt")
    os.remove(tmp_path / "run" / "scores.json")
    curves = tmp_path / "run" / "TrainResult" / "vdn" / "fov5" / "5by5-2d0b"
    for path in curves.glob("*_0.npy"):
        np.save(path, np.load(path)[:2])
    times = np.load(next(curves.glob("*runtime_0.npy")))
    a = ttq.parse(["--seed=3", f"--run_dir={tmp_path / 'run'}",
                   "--device=cpu", f"--out={tmp_path / 'ttq.json'}",
                   "--score_board=5", "--extra", *SMALL])
    trainer = ttq.train(a)
    # the whole run's schedule: the horizon of a fresh run of 1,200 env
    # steps, not of the 800 that remain; the count goes on from run 0's
    whole = ttq._args(a).update_env_info(trainer.env.env_info())
    assert trainer.args.total_env_steps == 800 != whole.total_env_steps
    assert (trainer.learner.opt.decay_steps == make_optimizer(
        whole).decay_steps != make_optimizer(trainer.args).decay_steps)
    first = checkpoint.load(str(model / "0_1_state.pt"))
    resumed = checkpoint.load(str(model / "1_final_state.pt"))
    assert (int(resumed["learner"]["opt_state"]["schedule_count"])
            == int(resumed["learner"]["train_step"])
            > int(first["learner"]["train_step"]))
    entry = ttq.write(a, ttq.score(a))
    assert [c["tag"] for c in entry["checkpoints"]] == ["0", "1", "2",
                                                        "final"]
    assert entry["resumed_at"] == [{"tag": "1", "env_steps": 400,
                                    "wall_s": float(times[1]), "as_run": 1}]
    assert "resumed" in entry["description"]
    walls = [c["wall_s"] for c in entry["checkpoints"]]
    assert walls[:2] == times.tolist() and walls == sorted(walls)
    assert ttq.train(a) is None   # ended: nothing to train


def test_bench_train_line_from_an_artifact(small_run, tmp_path):
    src, _ = small_run
    path = tmp_path / "time_to_quality.json"
    with open(src / "ttq.json") as f:
        data = json.load(f)
    data["first_crossing"] = data["checkpoints"][1]
    with open(path, "w") as f:
        json.dump(data, f)
    line = bench_train.time_to_quality_line(str(path))
    # JAX's line: this metric name and a null vs_baseline
    source = inspect.getsource(jbench_train.main)
    assert '"metric": "time_to_quality_recorded"' in source
    assert '"vs_baseline": None' in source
    assert line["metric"] == "time_to_quality_recorded"
    assert line["vs_baseline"] is None
    assert line["value"] == data["checkpoints"][1]["wall_s"]
    assert line["unit"] == (
        "s wall-clock to >=0.96 on 50x50 zero-shot (400 env steps, "
        f"flagship 20x20 recipe, {data['card']})")
    assert set(line) == {"metric", "value", "unit", "source", "vs_baseline"}


def test_bench_train_line_needs_an_artifact_and_a_crossing(small_run,
                                                         tmp_path):
    assert bench_train.time_to_quality_line(
        str(tmp_path / "missing.json")) is None
    src, entry = small_run
    assert entry["first_crossing"] is None   # an untrained 5x5 run
    assert bench_train.time_to_quality_line(str(src / "ttq.json")) is None
    assert bench_train.TIME_TO_QUALITY == str(
        ROOT / "marl_dmfb_tpu_torch" / "artifacts" / "time_to_quality.json")


PORT_ARTIFACT = ROOT / "marl_dmfb_tpu_torch" / "artifacts" / \
    "time_to_quality.json"
PORT_POLICY = ROOT / "tests" / "fixtures" / "torch_weights" / \
    "dmfb_20x20_4d_fov9_vdn_torch"


def test_committed_artifact_holds_two_seeds_of_the_recipe(jax_artifact):
    """The port's artifact: the flagship recipe at the CLI's seed and at
    ``--seed=1``, 41 checkpoints each (0..39 and final) scored on 50x50,
    the card named, its first crossing the fold's."""
    with open(PORT_ARTIFACT) as f:
        data = json.load(f)
    for entry, seed in ((data, 12), (data["seed_1_replication"], 1)):
        rows = entry["checkpoints"]
        assert [c["tag"] for c in rows] == [str(i) for i in range(40)] + [
            "final"]
        assert [c["env_steps"] for c in rows] == [
            i * 50000 for i in range(40)] + [2000000]
        assert set(rows[0]) == set(jax_artifact["checkpoints"][0])
        assert f"--seed={seed}" in entry["description"]
        for flag in ttq.RECIPES["flagship"].flags[1:]:
            assert flag in entry["description"]
        assert entry["card"] in entry["description"]
        assert "H100" in entry["card"] and " W" in entry["card"]
        assert entry == dict(entry, **ttq.fold(
            [c["success_50x50"] for c in rows], [c["wall_s"] for c in rows]))
    assert bench_train.time_to_quality_line()["value"] == (
        data["first_crossing"]["wall_s"])


def test_port_trained_export_loads_strictly():
    """The default seed's final EMA params, committed as a deploy export,
    load by name into the port's net with the net config they were saved
    with, bitwise, and a tree with one entry more or less is refused."""
    from marl_dmfb_tpu_torch.config import (get_evaluate_args,
                                            make_env_from_args)
    from marl_dmfb_tpu_torch.trainer import (Trainer, _named,
                                             restore_net_config)

    args = get_evaluate_args(["dmfb", "--drop_num=4", "--fov=9",
                              "--chip_size=20", "--device=cpu",
                              "--evaluate_task=4",
                              f"--data_dir={PORT_POLICY}"])
    path = checkpoint.model_state_path(args, "final")
    assert path.endswith("0_final_state.pt")
    assert os.path.getsize(path) < 2 ** 21
    tree = checkpoint.load(path)
    assert set(tree) == {"ema", "epsilon", "net_config"}
    restore_net_config(args, "final")
    assert (args.hyper_hidden_dim, args.rnn_hidden_dim) == (24, 128)
    trainer = Trainer(make_env_from_args(args), args, eval_only=True)
    trainer.load_model("final", params_only=True)
    net = dict(trainer.net.named_parameters())
    assert net.keys() == tree["ema"]["agent"].keys()
    for k, v in tree["ema"]["agent"].items():
        assert torch.equal(net[k], v), k
    template = _named(trainer.net)
    extra = {"agent": dict(tree["ema"]["agent"], extra=torch.zeros(1))}
    missing = {"agent": {k: v for k, v in tree["ema"]["agent"].items()
                         if k != "fc1.weight"}}
    for bad in (extra, missing):
        with pytest.raises(ValueError):
            checkpoint.restructure(template, bad, path)
    m = trainer.evaluate()
    assert 0.0 <= m["success_rate"] <= 1.0 and 0 < m["steps"] <= 80


# MEDA 15x30, 2 droplets (T = 45), 4 chips a rollout, a ring of 16, batches
# of 4, 10 tasks an online evaluation: 1,200 env steps, a checkpoint every
# 400
SMALL_MEDA = ["--width=15", "--length=30", "--drop_num=2",
              "--exact_steps=1200", "--evaluate_cycle=400",
              "--buffer_size=16", "--batch_size=4", "--n_parallel_envs=4",
              "--evaluate_task=10"]
MEDA_POLICY = ROOT / "tests" / "fixtures" / "torch_weights" / \
    "meda_30x60_3d_fov19_vdn_torch"


def _meda(tmp, *flags, seed=3):
    return ["--recipe=meda_30x60_3d", f"--seed={seed}",
            f"--run_dir={tmp / 'meda'}", "--device=cpu",
            f"--out={tmp / 'ttq.json'}", *flags, "--extra", *SMALL_MEDA]


class Killed(Exception):
    """The training's process ended from outside, as by a signal."""


@pytest.fixture(scope="module")
def meda_run(tmp_path_factory):
    """A MEDA run killed in its third online evaluation (its checkpoint 2
    saved, that checkpoint's time not yet recorded), folded; then resumed
    to its end and folded, into a copy of the port's committed artifact
    without its MEDA entry.  Returns the directory, the artifact after the
    killed run and after the whole one, and the resumed trainer."""
    from marl_dmfb_tpu_torch.trainer import Trainer

    tmp = tmp_path_factory.mktemp("ttq_meda")
    with open(PORT_ARTIFACT) as f:
        committed = json.load(f)
    committed.pop("meda_30x60_3d", None)
    with open(tmp / "ttq.json", "w") as f:
        json.dump(committed, f)
    torch.manual_seed(0)
    evaluate, calls = Trainer.evaluate, iter(range(10 ** 6))

    def killed_in_third(self, *args, **kwargs):
        if next(calls) == 2:
            raise Killed
        return evaluate(self, *args, **kwargs)

    # one thread: these small ops take several times longer on many
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(Trainer, "evaluate", killed_in_third)
            with pytest.raises(Killed):
                ttq.main(_meda(tmp))
        ttq.main(_meda(tmp, "--no_train"))
        with open(tmp / "ttq.json") as f:
            stopped = json.load(f)
        trainer = ttq.train(ttq.parse(_meda(tmp)))
        ttq.main(_meda(tmp, "--no_train"))
    finally:
        torch.set_num_threads(threads)
    with open(tmp / "ttq.json") as f:
        whole = json.load(f)
    return tmp, stopped, whole, trainer


def test_meda_recipe_is_jax_letter_for_letter():
    """The MEDA recipe trains JAX's flags (``artifacts/time_to_quality.json``
    ``meda_30x60_3d``) at the MEDA defaults, 2M env steps; the flagship
    stays the default."""
    a = ttq.parse(["--recipe=meda_30x60_3d", "--run_dir=x", "--device=cpu"])
    assert ttq.train_argv(a)[:5] == ["meda", "--drop_num=3",
                                     "--n_parallel_envs=64", "--lr_decay",
                                     "--param_ema=0.999"]
    args = ttq._args(a)
    assert (args.total_env_steps, args.evaluate_cycle) == (2_000_000, 50000)
    assert (args.width, args.length, args.fov, args.version) == (
        30, 60, 19, "0.2")
    assert (args.seed, args.mesh) == (12, "off")
    assert ttq.parse(["--run_dir=x"]).recipe == "flagship"


def test_stopped_meda_run_folds_as_far_as_it_reached(meda_run, jax_artifact):
    tmp, stopped, _, _ = meda_run
    entry = stopped["meda_30x60_3d"]
    assert [c["tag"] for c in entry["checkpoints"]] == ["0", "1"]
    assert [c["env_steps"] for c in entry["checkpoints"]] == [0, 400]
    # how far it reached, the horizon it trains to, no final
    run = entry["total_run"]
    assert (run["env_steps"], run["horizon"]) == (400, 1200)
    assert "success_final" not in run and "resumed_at" not in entry
    assert run["independent_final"]["tag"] == "1"
    model = tmp / "meda" / "model" / "vdn" / "fov19"
    assert not (model / "0_final_state.pt").exists()
    # checkpoint 2 was saved, but without its time it is no resume point
    assert (model / "0_2_state.pt").exists()
    assert ttq.segments(ttq.parse(_meda(tmp)))[0][2] == 1
    # the flagship's entries as they were
    with open(PORT_ARTIFACT) as f:
        committed = json.load(f)
    assert {k: v for k, v in stopped.items() if k != "meda_30x60_3d"} == {
        k: v for k, v in committed.items() if k != "meda_30x60_3d"}


def test_meda_run_writes_jax_keys_from_the_online_curve(meda_run,
                                                       jax_artifact):
    """Resumed, the run ends at its horizon with the whole run's
    learning-rate schedule; its entry has the keys of JAX's
    ``meda_30x60_3d``, its checkpoints the trainer's online curve, and an
    ``independent_final`` of the final checkpoint."""
    tmp, _, whole, trainer = meda_run
    entry = whole["meda_30x60_3d"]
    want = jax_artifact["meda_30x60_3d"]
    assert set(want) - {"seed_1_replication"} <= set(entry)
    assert [c["tag"] for c in entry["checkpoints"]] == ["0", "1", "2",
                                                        "final"]
    assert [c["env_steps"] for c in entry["checkpoints"]] == [0, 400, 800,
                                                              1200]
    for c in entry["checkpoints"]:
        assert set(c) == set(want["checkpoints"][0])
    curves = tmp / "meda" / "TrainResult" / "vdn" / "fov19" / "15by30-2d0b"
    online = [np.load(next(curves.glob(f"*success_rate_{run}.npy")))
              for run in (0, 1)]
    assert [c["success"] for c in entry["checkpoints"]] == [
        round(float(x), 2) for x in (*online[0][:2], *online[1][1:])]
    assert set(entry["total_run"]) == {"env_steps", "wall_s",
                                       "success_final", "independent_final"}
    independent = entry["total_run"]["independent_final"]
    assert set(independent) == {"tag", "n_tasks", "steps", "success"}
    assert (independent["tag"], independent["n_tasks"]) == ("final", 100)
    assert 0 < independent["steps"] <= 45
    assert entry["resumed_at"] == [{
        "tag": "1", "env_steps": 400, "as_run": 1,
        "wall_s": entry["checkpoints"][1]["wall_s"]}]
    assert "--seed=3" in entry["description"]
    assert "meda --drop_num=3 --n_parallel_envs=64 --lr_decay " \
        "--param_ema=0.999 --evaluate_cycle=50000" in entry["description"]
    args = ttq._args(ttq.parse(_meda(tmp)))
    whole_args = args.update_env_info(trainer.env.env_info())
    assert trainer.args.total_env_steps == 800 != whole_args.total_env_steps
    assert (trainer.learner.opt.decay_steps
            == make_optimizer(whole_args).decay_steps)
    # the deploy export holds the final checkpoint's EMA params
    final = checkpoint.load(str(tmp / "meda" / "model" / "vdn" / "fov19" /
                                "1_final_state.pt"))
    deploy = checkpoint.load(str(tmp / "meda" / "deploy" / "model" / "vdn" /
                                 "fov19" / "0_final_state.pt"))
    for k, v in final["ema"]["agent"].items():
        assert torch.equal(deploy["ema"]["agent"][k], v), k
    assert ttq.train(ttq.parse(_meda(tmp))) is None


def test_second_meda_seed_nests_in_the_meda_entry(meda_run, tmp_path):
    src, _, whole, _ = meda_run
    shutil.copytree(src / "meda", tmp_path / "meda")
    shutil.copy(src / "ttq.json", tmp_path / "ttq.json")
    ttq.main(_meda(tmp_path, "--no_train", "--key=seed_1_replication",
                   seed=1))
    with open(tmp_path / "ttq.json") as f:
        written = json.load(f)
    entry = written["meda_30x60_3d"]
    nested = entry.pop("seed_1_replication")
    assert nested["note"] == "same recipe, --seed=1"
    assert "--seed=1" in nested["description"]
    assert nested["checkpoints"] == entry["checkpoints"]
    assert entry == whole["meda_30x60_3d"]
    assert {k: v for k, v in written.items() if k != "meda_30x60_3d"} == {
        k: v for k, v in whole.items() if k != "meda_30x60_3d"}


def test_committed_artifact_holds_two_meda_seeds(jax_artifact):
    """The port's MEDA entry: JAX's recipe at the CLI's seed and at
    ``--seed=1``, each with a checkpoint every 50k past 800k scored by the
    trainer's online evaluation, the card named, the newest checkpoint
    evaluated independently, and its first crossing the fold's."""
    with open(PORT_ARTIFACT) as f:
        meda = json.load(f)["meda_30x60_3d"]
    flags = ("meda --drop_num=3 --n_parallel_envs=64 --lr_decay "
             "--param_ema=0.999 --evaluate_cycle=50000")
    for entry, seed in ((meda, 12), (meda["seed_1_replication"], 1)):
        rows = entry["checkpoints"]
        ended = rows[-1]["tag"] == "final"
        n = len(rows) - ended
        assert n >= 17   # 0 .. 16, 800k env steps
        assert [c["tag"] for c in rows[:n]] == [str(i) for i in range(n)]
        assert [c["env_steps"] for c in rows[:n]] == [
            i * 50000 for i in range(n)]
        assert set(rows[0]) == set(jax_artifact["meda_30x60_3d"][
            "checkpoints"][0])
        assert f"{flags} --seed={seed} (2000000 env steps" in (
            entry["description"])
        assert entry["card"] in entry["description"]
        assert "H100" in entry["card"] and " W" in entry["card"]
        independent = entry["total_run"]["independent_final"]
        assert independent["n_tasks"] == 100
        assert independent["tag"] == rows[-1]["tag"]
        assert entry["resumed_at"]
        folded = ttq.fold([c["success"] for c in rows],
                          [c["wall_s"] for c in rows], key="success",
                          ended=ended)
        first = folded.pop("first_crossing")
        assert {k: v for k, v in entry["first_crossing"].items()
                if k != "after_resume_at"} == first
        folded["total_run"]["independent_final"] = independent
        assert entry == dict(entry, **folded)


def test_port_trained_meda_export_loads_strictly():
    """The MEDA seed-12 run's newest EMA params, committed as a deploy
    export, load by name into the port's MEDA 3-droplet net bitwise, and a
    greedy rollout of a few tasks on the CPU runs."""
    from marl_dmfb_tpu_torch.config import (get_evaluate_args,
                                            make_env_from_args)
    from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config

    args = get_evaluate_args(["meda", "--drop_num=3", "--device=cpu",
                              "--evaluate_task=3",
                              f"--data_dir={MEDA_POLICY}"])
    path = checkpoint.model_state_path(args, "final")
    assert path.endswith("vdn/fov19/0_final_state.pt")
    assert os.path.getsize(path) < 2 ** 21
    tree = checkpoint.load(path)
    assert set(tree) == {"ema", "epsilon", "net_config"}
    restore_net_config(args, "final")
    trainer = Trainer(make_env_from_args(args), args, eval_only=True)
    assert (args.width, args.length, args.n_agents) == (30, 60, 3)
    trainer.load_model("final", params_only=True)
    net = dict(trainer.net.named_parameters())
    assert net.keys() == tree["ema"]["agent"].keys()
    for k, v in tree["ema"]["agent"].items():
        assert torch.equal(net[k], v), k
    m = trainer.evaluate()
    assert 0.0 <= m["success_rate"] <= 1.0 and 0 < m["steps"] <= 90


def _seeds_tool():
    spec = importlib.util.spec_from_file_location(
        "time_to_quality_seeds", ROOT / "tools" / "time_to_quality_seeds.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_seeds_fail_on_a_signal_not_on_the_budget():
    """A process that exits 0 passes, one that runs past the deadline is
    ended there and passes, and one that exits 3 or dies of a signal
    fails."""
    seeds = _seeds_tool()
    code = {1: "pass", 2: "import time; time.sleep(60)",
            3: "raise SystemExit(3)",
            4: "import os, signal; os.kill(os.getpid(), signal.SIGKILL)"}
    procs = [(seed, subprocess.Popen([sys.executable, "-c", c]))
             for seed, c in code.items()]
    start = time.monotonic()
    assert seeds.wait(procs, start + 5.0) == [3, 4]
    assert time.monotonic() - start < 30
    assert procs[1][1].returncode == -signal.SIGTERM


def test_packed_run_keeps_what_resumes_it(meda_run, tmp_path):
    """``tools/time_to_quality_seeds.py``'s pack keeps the checkpoint each
    run resumes from (run 0's checkpoint 1, not its newer 2, whose time
    was never recorded) and its final one, the curves, the scores and the
    deploy export, and the tool reads the same runs from it."""
    seeds = _seeds_tool()
    src, _, _, _ = meda_run
    seeds.pack(ttq.parse(_meda(src)), str(tmp_path / "meda"))
    model = tmp_path / "meda" / "model" / "vdn" / "fov19"
    assert sorted(p.name for p in model.iterdir()) == [
        "0_1_state.pt", "1_1_state.pt", "1_final_state.pt"]
    assert (tmp_path / "meda" / "scores.json").exists()
    assert (tmp_path / "meda" / "deploy" / "model" / "vdn" / "fov19" /
            "0_final_state.pt").exists()
    assert ttq.segments(ttq.parse(_meda(tmp_path))) == ttq.segments(
        ttq.parse(_meda(src)))
    a = seeds.parse(["--runs", "meda_30x60_3d:12", "meda_30x60_3d:1",
                     "--budget=10", f"--out={tmp_path}"])
    assert seeds.runs(a) == [("meda_30x60_3d", 12, "default"),
                             ("meda_30x60_3d", 1, "seed_1_replication")]


# The recipes of the QMIX and bf16 flagships, the seed farm and the mesh,
# each cut to SMALL (the farm to 2 seeds, the mesh to 2 gloo ranks); QMIX
# scored on 6x6 (``--score_board``) and every checkpoint also on 7x7 over
# 20 tasks and on its 5x5 training board over 30 (in place of 10x10 and
# 20x20 over 500), bf16 on 5x5 and the mesh's newest checkpoint also on
# 5x5, in place of the recipes' boards (QMIX's other boards and the mesh's
# final boards patched into ``ttq.RECIPES``).
QMIX_BOARDS = ((7, 20), (5, 30))
RECIPE_JAX_TAGS = {"dmfb_flagship_qmix": 41, "dmfb_flagship_bf16": 41,
                   "seedfarm_10x10_2d": 7, "mesh_10x10_2d": 13}


def _recipe(tmp, recipe, *flags, extra=()):
    return [f"--recipe={recipe}", "--seed=3", f"--run_dir={tmp / recipe}",
            "--device=cpu", f"--out={tmp / 'ttq.json'}", *flags,
            "--extra", *SMALL, *extra]


@pytest.fixture(scope="module")
def recipe_runs(tmp_path_factory):
    """The four recipes, each trained, scored and folded into one
    artifact; returns the directory, the artifact and the evaluate
    entry point's argument lists."""
    from marl_dmfb_tpu_torch import evaluate

    tmp = tmp_path_factory.mktemp("ttq_recipes")
    calls, main = [], evaluate.main

    def recorded(argv=None):
        calls.append(list(argv))
        return main(argv)

    torch.manual_seed(0)
    # one thread: on a loaded host many threads slow these small ops
    # by orders of magnitude
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(evaluate, "main", recorded)
            m.setitem(ttq.RECIPES, "mesh_10x10_2d", ttq.RECIPES[
                "mesh_10x10_2d"]._replace(final_boards=(5,)))
            _cut(m, "dmfb_flagship_qmix", QMIX_BOARDS)
            ttq.main(_recipe(tmp, "dmfb_flagship_qmix", "--score_board=6"))
            ttq.main(_recipe(tmp, "dmfb_flagship_bf16", "--score_board=5"))
            ttq.main(_recipe(tmp, "seedfarm_10x10_2d",
                             extra=["--vmap_seeds=2"]))
            ttq.main(_recipe(tmp, "mesh_10x10_2d",
                             extra=["--mesh=2", "--evaluate_task=10"]))
    finally:
        torch.set_num_threads(threads)
    with open(tmp / "ttq.json") as f:
        return tmp, json.load(f), calls


def _scored(calls, recipe):
    return [c for c in calls if any(f"{recipe}" in x for x in c)]


def test_qmix_recipe_scores_its_own_checkpoints(recipe_runs, jax_artifact):
    """QMIX checkpoints go under ``model/qmix/``; every one is scored from
    there by ``evaluate --alg=qmix`` (the parent tool passed no ``--alg``
    and looked under ``vdn/``) on a board other than the training's, where
    the port's own checkpoint loads its agent and drops its mixer, and on
    each of the recipe's other boards, the training board among them."""
    tmp, data, calls = recipe_runs
    entry = data["dmfb_flagship_qmix"]
    model = tmp / "dmfb_flagship_qmix" / "model"
    assert sorted(p.name for p in model.iterdir()) == ["qmix"]
    scored = _scored(calls, "dmfb_flagship_qmix")
    assert len(scored) == 4 * 3 and all("--alg=qmix" in c for c in scored)
    # the parent tool's call, without --alg, finds no checkpoint
    from marl_dmfb_tpu_torch import evaluate
    with pytest.raises(FileNotFoundError, match="vdn"):
        evaluate.main([x for x in scored[0] if not x.startswith("--alg")])
    assert [c["tag"] for c in entry["checkpoints"]] == ["0", "1", "2",
                                                        "final"]
    for c in entry["checkpoints"]:
        assert set(c) == set(jax_artifact["checkpoints"][0]) | {
            "success_7x7", "success_5x5"}
    assert set(entry["total_run"]) == {"env_steps", "wall_s",
                                       "success_50x50_final",
                                       "success_7x7_final",
                                       "success_5x5_final"}
    assert "--alg=qmix" in entry["description"]
    assert "fresh mixer" in entry["description"]
    r = ttq.RECIPES["dmfb_flagship_qmix"]
    assert r.final_boards == () and r.boards == ((10, 500), (20, 500))


def test_every_checkpoint_is_scored_on_each_board(recipe_runs):
    """A recipe with other boards scores every checkpoint on each, through
    the evaluate entry point over that board's number of tasks, once; the
    fold writes each reading beside the checkpoint's success, the newest's
    in ``total_run``, each key's tasks in ``n_tasks``; both flagships
    score every checkpoint on 10x10 and 20x20 over 500 tasks by default,
    and the seeds tool folds a run under the key that ``--runs`` names."""
    tmp, data, calls = recipe_runs
    entry = data["dmfb_flagship_qmix"]
    scored = _scored(calls, "dmfb_flagship_qmix")
    with open(tmp / "dmfb_flagship_qmix" / "scores.json") as f:
        scores = json.load(f)
    tags = ["0_0", "0_1", "0_2", "0_final"]
    for board, tasks in QMIX_BOARDS:
        on = [c for c in scored if f"--chip_size={board}" in c]
        assert [c[c.index(f"--evaluate_task={tasks}") + 2] for c in on] == [
            f"--load_model_name={t}" for t in tags]
        readings = [c[f"success_{board}x{board}"]
                    for c in entry["checkpoints"]]
        assert readings == [scores[ttq.board_key(t, board, tasks)]
                            for t in tags]
        assert all(0.0 <= x <= 1.0 for x in readings)
        # a whole number of tasks, to three decimals
        assert all(abs(x * tasks - round(x * tasks)) <= tasks * 5e-4
                   for x in readings)
        assert entry["total_run"][f"success_{board}x{board}_final"] == (
            readings[-1])
        assert (f"every checkpoint also on {board}x{board}, {tasks} tasks"
                in entry["description"])
    assert entry["n_tasks"] == {"success_50x50": 100, "success_7x7": 20,
                                "success_5x5": 30}
    rows = entry["checkpoints"]
    assert rows == ttq.fold(
        [c["success_50x50"] for c in rows], [c["wall_s"] for c in rows],
        total_steps=1200, cycle=400, others={
            f"success_{b}x{b}": [c[f"success_{b}x{b}"] for c in rows]
            for b, _ in QMIX_BOARDS})["checkpoints"]
    for recipe in ("flagship", "dmfb_flagship_qmix"):
        assert ttq.RECIPES[recipe].boards == ((10, 500), (20, 500))
    seeds = _seeds_tool()
    a = seeds.parse(["--runs", "dmfb_flagship_qmix:12", "dmfb_flagship_qmix:1",
                     "flagship:12:seed_12_control", "--budget=1",
                     "--out=x"])
    assert seeds.runs(a) == [("dmfb_flagship_qmix", 12, "default"),
                             ("dmfb_flagship_qmix", 1, "seed_1_replication"),
                             ("flagship", 12, "seed_12_control")]


def test_a_board_read_over_other_tasks_is_read_again(recipe_runs, tmp_path,
                                                     monkeypatch):
    """A run directory whose checkpoints were read on 7x7 over 20 tasks,
    scored and folded where the recipe reads 7x7 over 10, reads each
    checkpoint again over 10 and folds those readings: a reading over
    other tasks is never written under the recipe's ``n_tasks``."""
    from marl_dmfb_tpu_torch import evaluate

    src, _, _ = recipe_runs
    shutil.copytree(src / "dmfb_flagship_qmix",
                    tmp_path / "dmfb_flagship_qmix")
    calls, main = [], evaluate.main

    def recorded(argv=None):
        calls.append(list(argv))
        return main(argv)

    monkeypatch.setattr(evaluate, "main", recorded)
    _cut(monkeypatch, "dmfb_flagship_qmix", ((7, 10),))
    a = ttq.parse(_recipe(tmp_path, "dmfb_flagship_qmix", "--score_board=6"))
    scores = ttq.score(a)
    entry = ttq.write(a, scores)
    tags = ["0_0", "0_1", "0_2", "0_final"]
    named = ("--chip_size", "--evaluate_task", "--load_model_name")
    assert [[x for x in c if x.startswith(named)] for c in calls] == [
        ["--chip_size=7", "--evaluate_task=10", f"--load_model_name={t}"]
        for t in tags]
    readings = [c["success_7x7"] for c in entry["checkpoints"]]
    assert readings == [scores[ttq.board_key(t, 7, 10)] for t in tags]
    assert all(ttq.board_key(t, 7, 20) in scores for t in tags)
    assert all(abs(x * 10 - round(x * 10)) < 1e-6 for x in readings)
    assert entry["n_tasks"] == {"success_50x50": 100, "success_7x7": 10}
    assert "success_5x5" not in entry["checkpoints"][0]


def test_bf16_recipe_scores_float32_master_weights(recipe_runs):
    """bf16 trains with ``--compute_dtype=bf16`` and saves float32 params;
    its checkpoints are scored on the float32 path, as JAX scored its
    run, and the entry says so."""
    tmp, data, calls = recipe_runs
    entry = data["dmfb_flagship_bf16"]
    a = ttq.parse(_recipe(tmp, "dmfb_flagship_bf16"))
    assert ttq._args(a).compute_dtype == "bf16"
    scored = _scored(calls, "dmfb_flagship_bf16")
    assert len(scored) == 4
    assert not any("--compute_dtype" in x for c in scored for x in c)
    tree = checkpoint.load(ttq._ckpt(a, 0, "final"))
    for part in ("agent", "ema"):
        params = tree["ema"]["agent"] if part == "ema" else \
            tree["learner"]["params"]["agent"]
        assert {v.dtype for v in params.values()} == {torch.float32}
    assert "--compute_dtype=bf16" in entry["description"]
    assert ("trained in bf16; scored on the float32 evaluation path on the "
            "float32 master weights") in entry["description"]


def test_farm_folds_each_seed_into_one_entry(recipe_runs):
    """The farm's (S, E) online curves and each seed's final checkpoint,
    scored by ``evaluate`` from that seed's run, fold into one entry."""
    from marl_dmfb_tpu_torch.trainer import curve_dir, curve_prefix

    tmp, data, calls = recipe_runs
    entry = data["seedfarm_10x10_2d"]
    args = ttq._args(ttq.parse(_recipe(tmp, "seedfarm_10x10_2d",
                                       extra=["--vmap_seeds=2"])))
    base = os.path.join(curve_dir(args), curve_prefix(args))
    success = np.load(f"{base}success_rate_farm.npy")
    assert success.shape == (2, 4)
    assert entry["seeds"] == [3, 4]
    assert [c["tag"] for c in entry["checkpoints"]] == ["0", "1", "2",
                                                        "final"]
    assert [c["success"] for c in entry["checkpoints"]] == [
        [round(float(x), 2) for x in success[:, i]] for i in range(4)]
    assert [c["wall_s"] for c in entry["checkpoints"]] == np.load(
        f"{base}runtime_farm.npy").tolist()
    assert len(entry["first_crossing"]) == 2
    finals = entry["total_run"]["independent_final"]
    assert [f["tag"] for f in finals] == ["final", "final"]
    assert entry["total_run"]["success_final"] == entry["checkpoints"][-1][
        "success"]
    scored = _scored(calls, "seedfarm_10x10_2d")
    assert [c[-2] for c in scored] == ["--load_model_name=0_final",
                                       "--load_model_name=1_final"]
    assert (tmp / "seedfarm_10x10_2d" / "deploy" / "model" / "vdn" / "fov5" /
            "0_final_state.pt").exists()


def test_mesh_recipe_folds_rank_zero(recipe_runs):
    """The mesh recipe trains on 2 gloo ranks through the train CLI and
    folds rank 0's online curve and its final checkpoint's scores."""
    tmp, data, calls = recipe_runs
    entry = data["mesh_10x10_2d"]
    a = ttq.parse(_recipe(tmp, "mesh_10x10_2d",
                          extra=["--mesh=2", "--evaluate_task=10"]))
    assert ttq.on_mesh(a) and "--mesh=off" not in ttq.train_argv(a)
    assert ttq._args(a).mesh == "2"
    online = ttq.runtime(a, 0, "success_rate")
    assert [c["success"] for c in entry["checkpoints"]] == [
        round(x, 2) for x in online]
    assert [c["tag"] for c in entry["checkpoints"]] == ["0", "1", "2",
                                                        "final"]
    run = entry["total_run"]
    assert run["independent_final"]["tag"] == "final"
    assert run["independent_final_5x5"]["n_tasks"] == 100
    assert "--mesh=4" in entry["description"]
    assert "--mesh=4" in ttq.train_argv(ttq.parse(
        ["--recipe=mesh_10x10_2d", "--run_dir=x"]))


@pytest.mark.parametrize("recipe", sorted(RECIPE_JAX_TAGS))
def test_committed_recipe_entries(recipe):
    """Each recipe's committed entry: trained on the H100, named with its
    power limit, the recipe's flags and seed in the description, JAX's
    checkpoint tags (a prefix of them where the run was stopped before its
    end), and the fold's first crossing."""
    with open(PORT_ARTIFACT) as f:
        entry = json.load(f)[recipe]
    r = ttq.RECIPES[recipe]
    assert "H100" in entry["card"] and " W" in entry["card"]
    assert entry["card"] in entry["description"]
    assert " ".join(r.flags + ["--seed=12"]) in entry["description"]
    rows = entry["checkpoints"]
    n = RECIPE_JAX_TAGS[recipe]
    jax_tags = [str(i) for i in range(n - 1)] + ["final"]
    tags = [c["tag"] for c in rows]
    ended = tags[-1] == "final"
    assert tags == (jax_tags if ended else jax_tags[:len(tags)])
    cycle = 100000 if recipe.startswith("seedfarm") else 50000
    assert [c["env_steps"] for c in rows[:n - 1]] == [
        i * cycle for i in range(min(len(rows), n - 1))]
    others = {f"success_{b}x{b}": [c[f"success_{b}x{b}"] for c in rows]
              for b, _ in r.boards}
    folded = ttq.fold([c[r.success] for c in rows],
                      [c["wall_s"] for c in rows], cycle=cycle,
                      total_steps=2_000_000 if r.board else 600_000,
                      key=r.success, ended=ended, others=others)
    assert entry["checkpoints"] == folded["checkpoints"]
    first = entry["first_crossing"]
    strip = (lambda c: c if c is None else
             {k: v for k, v in c.items() if k != "after_resume_at"})
    assert (list(map(strip, first)) if isinstance(first, list)
            else strip(first)) == folded["first_crossing"]
    if recipe.startswith("seedfarm"):
        assert entry["seeds"] == list(range(12, 20))
        assert {len(c["success"]) for c in rows} == {8}
    if r.boards:
        assert entry["n_tasks"] == {r.success: ttq.N_TASKS, **{
            f"success_{b}x{b}": n for b, n in r.boards}}


# the runs trained unbroken from scratch in one call, three at once, each
# with every checkpoint on 10x10 and 20x20: (recipe entry, nested key, seed)
CROSS_BOARD_RUNS = [("dmfb_flagship_qmix", None, 12),
                    ("dmfb_flagship_qmix", "seed_1_replication", 1),
                    ("", "seed_12_control", 12)]


@pytest.mark.parametrize("where,key,seed", CROSS_BOARD_RUNS,
                         ids=["qmix_s12", "qmix_s1", "vdn_control_s12"])
def test_committed_cross_board_runs(where, key, seed):
    """Two QMIX seeds and a VDN control of the flagship recipe, trained
    from scratch without a resume on one card at once: every checkpoint
    scored on 50x50 (100 tasks) and on 10x10 and 20x20 (500 tasks each),
    the same checkpoints for all three, each the fold of its readings."""
    with open(PORT_ARTIFACT) as f:
        data = json.load(f)
    entry = data[where] if where else data
    entry = entry[key] if key else entry
    recipe = "dmfb_flagship_qmix" if where else "flagship"
    r = ttq.RECIPES[recipe]
    assert " ".join(r.flags + [f"--seed={seed}"]) in entry["description"]
    assert "H100" in entry["card"] and " W" in entry["card"]
    assert "resumed_at" not in entry and "resumed" not in entry[
        "description"]
    rows = entry["checkpoints"]
    assert [c["tag"] for c in rows] == [str(i) for i in range(len(rows))]
    assert len(rows) >= 20
    assert entry["n_tasks"] == {"success_50x50": 100, "success_10x10": 500,
                                "success_20x20": 500}
    for c in rows:   # a whole number of tasks each
        for k, n in entry["n_tasks"].items():
            assert abs(c[k] * n - round(c[k] * n)) < 1e-6, (c, k)
    others = {k: [c[k] for c in rows] for k in ("success_10x10",
                                                 "success_20x20")}
    folded = ttq.fold([c["success_50x50"] for c in rows],
                      [c["wall_s"] for c in rows], ended=False,
                      others=others)
    assert rows == folded["checkpoints"]
    assert entry["total_run"] == dict(
        folded["total_run"], success_10x10_newest=rows[-1]["success_10x10"],
        success_20x20_newest=rows[-1]["success_20x20"])


def test_seeds_tool_runs_each_recipe_and_packs_a_farm(recipe_runs,
                                                      tmp_path):
    """``tools/time_to_quality_seeds.py`` takes several recipes, a process
    for each recipe and seed; an ended farm packs its curves, scores and
    deploy export and none of its checkpoints, and a stopped one keeps its
    newest resume checkpoint, from which the tool reads the same curves
    and the train CLI's ``--load_model`` carries the farm to its end."""
    seeds = _seeds_tool()
    a = seeds.parse(["--runs", "dmfb_flagship_qmix:12", "seedfarm_10x10_2d:12",
                     "--budget=10", f"--out={tmp_path}"])
    assert seeds.runs(a) == [("dmfb_flagship_qmix", 12, "default"),
                             ("seedfarm_10x10_2d", 12, "default")]
    assert seeds.tool_argv(a, "seedfarm_10x10_2d", 12)[2:4] == [
        "--recipe=seedfarm_10x10_2d", "--seed=12"]
    src, _, _ = recipe_runs
    argv = _recipe(src, "seedfarm_10x10_2d", extra=["--vmap_seeds=2"])
    seeds.pack(ttq.parse(argv), str(tmp_path / "ended"))
    packed = [p.relative_to(tmp_path / "ended").as_posix()
              for p in (tmp_path / "ended").rglob("*.pt")]
    assert packed == ["deploy/model/vdn/fov5/0_final_state.pt"]
    assert (tmp_path / "ended" / "scores.json").exists()
    # stopped after its second evaluation: no farm curves yet
    stopped = tmp_path / "stopped"
    shutil.copytree(src / "seedfarm_10x10_2d", stopped)
    for path in stopped.rglob("*_farm.npy"):
        os.remove(path)
    t = ttq.parse(_recipe(tmp_path, "seedfarm_10x10_2d",
                          extra=["--vmap_seeds=2"]))
    t.run_dir = str(stopped)
    success, times, ended, newest = ttq.farm_progress(t)
    assert not ended and newest == "2" and success.shape == (2, 3)
    seeds.pack(t, str(tmp_path / "packed"))
    model = tmp_path / "packed" / "model" / "vdn" / "fov5"
    assert sorted(p.name for p in model.iterdir()) == ["farm_2_resume.pt"]
    t.run_dir = str(tmp_path / "packed")
    again = ttq.farm_progress(t)
    assert np.array_equal(again[0], success) and again[3] == "2"
    torch.manual_seed(0)
    ttq.train(t)
    done, _, ended, newest = ttq.farm_progress(t)
    assert ended and newest == "final" and done.shape == (2, 4)
    assert np.array_equal(done[:, :3], success)


# the recipes' deploy exports (the JAX artifact's name + "_torch"): the
# evaluate CLI of each one's training board
RECIPE_EXPORTS = {
    "dmfb_20x20_4d_fov9_qmix_torch": ["dmfb", "--drop_num=4", "--fov=9",
                                      "--chip_size=20", "--alg=qmix"],
    "dmfb_20x20_4d_bf16_torch": ["dmfb", "--drop_num=4", "--fov=9",
                                 "--chip_size=20"],
    "seedfarm_10x10_2d_torch": ["dmfb", "--drop_num=2"],
    "mesh8_10x10_2d_torch": ["dmfb", "--drop_num=2"],
}


@pytest.mark.parametrize("name", sorted(RECIPE_EXPORTS))
def test_recipe_exports_load_strictly(name):
    """Each recipe's committed deploy export (the run's newest EMA params,
    QMIX's mixer among them) loads by name into the port's nets bitwise,
    and a greedy rollout of a few tasks on the CPU runs."""
    from marl_dmfb_tpu_torch.config import (get_evaluate_args,
                                            make_env_from_args)
    from marl_dmfb_tpu_torch.trainer import (Trainer, _named,
                                             restore_net_config)

    args = get_evaluate_args(RECIPE_EXPORTS[name] + [
        "--device=cpu", "--evaluate_task=3",
        f"--data_dir={PORT_POLICY.parent / name}"])
    path = checkpoint.model_state_path(args, "final")
    assert path.endswith(f"{args.alg}/fov9/0_final_state.pt")
    assert os.path.getsize(path) < 2 ** 21
    tree = checkpoint.load(path)
    assert set(tree) == {"ema", "epsilon", "net_config"}
    restore_net_config(args, "final")
    trainer = Trainer(make_env_from_args(args), args, eval_only=True)
    trainer.load_model("final", params_only=True)
    live = _named(trainer.net, trainer.mixer)
    assert live.keys() == tree["ema"].keys()
    for part, params in tree["ema"].items():
        assert live[part].keys() == params.keys()
        for k, v in params.items():
            assert v.dtype == torch.float32
            assert torch.equal(live[part][k], v), (part, k)
    m = trainer.evaluate()
    assert 0.0 <= m["success_rate"] <= 1.0


def test_ring_size_tool_counts_the_qmix_ring():
    """``tools/ring_size_torch.py`` counts the DMFB QMIX flagship's ring
    field by field as ``replay.init_replay`` lays it out (5000 episodes,
    T = 80, 4 agents of 245 int8 observation values, a state of 1200 int8
    values), without allocating it, and packs a ring filled with a
    rollout of the committed QMIX export."""
    spec = importlib.util.spec_from_file_location(
        "ring_size_torch", ROOT / "tools" / "ring_size_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    line = tool.main([
        "--policy", str(PORT_POLICY.parent / "dmfb_20x20_4d_fov9_qmix_torch"),
        "--episodes", "8", "--", "dmfb", "--drop_num=4", "--fov=9",
        "--chip_size=20", "--alg=qmix", "--n_parallel_envs=8"])
    S, T, N = 5000, 80, 4
    assert line["bytes_by_field"] == {
        "o_ext": S * (T + 1) * N * 245, "u": S * T * N, "r": S * T * 4,
        "padded": S * T, "terminated": S * T, "s_ext": S * (T + 1) * 1200}
    assert line["bytes"] == sum(line["bytes_by_field"].values())
    assert 1 <= line["mean_episode_steps"] <= T
    # the filled rows are saved whole, and gzip packs their zero padding
    assert line["filled_saved_bytes"] > 8 * (T + 1) * (N * 245 + 1200)
    assert 0 < line["filled_gzip_bytes"] < line["filled_saved_bytes"]
