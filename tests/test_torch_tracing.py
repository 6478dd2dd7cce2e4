"""The port's own spans and counters (``marl_dmfb_tpu_torch/utils/
tracing.py``) on the CPU: off by default, where a cycle records nothing and
enters no profiler range; the same results bitwise with tracing on and
off; the structure of a traced cycle (DMFB, MEDA and the seed farm): each
span inside its parent, the per-step and per-update call counts and the
counters; under QMIX the mixer's ``learn.mix`` and the rollout's
``rollout.state`` (neither under VDN), ``learn.mix.rows`` and results
bitwise the same on and off; a ``torch.profiler`` session's ``marl.*``
ranges and its own fresh record; the summary's self times; ``train
--profile_dir``'s files; and the farm's split of its gradients into a
forward and a backward, equal to the vmapped ``grad_and_value`` it
replaced.  On a machine with a card
(``cuda``-marked): each span's device time from its CUDA events.

No JAX here, so that the card's machine can run the ``cuda`` test:
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``.
"""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from marl_dmfb_tpu_torch import train
from marl_dmfb_tpu_torch.algos.qlearn import functional_loss
from marl_dmfb_tpu_torch.config import Args, make_env_from_args
from marl_dmfb_tpu_torch.parallel.seedfarm import SeedFarm
from marl_dmfb_tpu_torch.replay import sample_stacked
from marl_dmfb_tpu_torch.trainer import Trainer
from marl_dmfb_tpu_torch.utils import tracing

torch.set_num_threads(1)

ROLLOUT_STEP = ("rollout.act", "rollout.env_step", "rollout.record")
UPDATE = ("learn.sample", "learn.forward", "learn.backward", "learn.optim")
# DMFB 10x10, 2 droplets, fov 5; small nets; 4 chips a rollout and 2
# updates a cycle on minibatches of 4; the EMA on
DMFB = dict(name="dmfb", drop_num=2, fov=5, width=10, length=10,
            rnn_hidden_dim=16, hyper_hidden_dim=8, batch_size=4,
            buffer_size=16, n_parallel_envs=4, train_time=1,
            evaluate_task=4, param_ema=0.99)
MEDA = dict(name="meda", drop_num=2, width=15, length=30, fov=19,
            rnn_hidden_dim=16, hyper_hidden_dim=8, batch_size=2,
            buffer_size=4, n_parallel_envs=2, train_time=2,
            evaluate_task=2, param_ema=0.99)


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def make_args(tmp_path, conf=DMFB, **kw) -> Args:
    a = Args(**{**conf, "device": "cpu", **kw}, data_dir=str(tmp_path))
    a.apply_env_defaults()
    return a


def trainer(args) -> Trainer:
    t = Trainer(make_env_from_args(args), args)
    t.train_cycle()   # a ring to sample from
    return t


def state_of(t: Trainer) -> dict:
    return {"loss": t.losses[-1].clone(),
            "params": {k: v.detach().clone()
                       for k, v in t.learner.all_params.items()},
            "ema": {k: v.detach().clone()
                    for k, v in t.ema_net.named_parameters()},
            "ring": {k: v.clone() for k, v in t.replay.data.items()},
            "generator": t.generator.get_state().clone(),
            "epsilon": torch.as_tensor(t.epsilon).clone()}


def assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_equal(a[k], b[k])
    else:
        assert torch.equal(a, b)


def children(recs, i):
    return [r for r in recs if r["parent"] == i]


def check_cycle(recs, T, updates, ema=True):
    """One ``train_cycle`` record tree: its children in order, each inside
    its parent, the per-step and per-update spans."""
    top = [i for i, r in enumerate(recs) if r["parent"] is None]
    assert [recs[i]["name"] for i in top] == ["train_cycle"]
    for r in recs:
        assert r["end_ns"] is not None and r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
        assert r["cycle"] == recs[top[0]]["cycle"]
    kids = children(recs, top[0])
    assert [r["name"] for r in kids] == (
        ["rollout", "store", "learn_many"] + (["ema"] if ema else []))
    for a, b in zip(kids, kids[1:]):
        assert a["end_ns"] <= b["start_ns"]
    rollout, learn = recs.index(kids[0]), recs.index(kids[2])
    assert [r["name"] for r in children(recs, rollout)] == (
        ["rollout.reset"] + list(ROLLOUT_STEP) * T + ["rollout.pack"])
    assert [r["name"] for r in children(recs, learn)] == list(UPDATE) * updates
    for i, r in enumerate(recs):
        if r["name"] not in ("train_cycle", "rollout", "learn_many"):
            assert not children(recs, i), r["name"]


@pytest.mark.parametrize("conf", [DMFB, MEDA], ids=["dmfb", "meda"])
def test_enabled_cycle_has_the_spans_in_their_parents(conf, tmp_path):
    t = trainer(make_args(tmp_path, conf))
    tracing.enable()
    t.train_cycle()
    tracing.disable()
    T, B, U = t.args.episode_limit, t.B, t.updates_per_rollout
    check_cycle(tracing.records(), T, U)
    s = tracing.summary()
    assert s["cycles"] == 1
    assert {k: v["calls"] for k, v in s["spans"].items()} == {
        "train_cycle": 1, "rollout": 1, "rollout.reset": 1,
        **{k: T for k in ROLLOUT_STEP}, "rollout.pack": 1, "store": 1, "learn_many": 1,
        **{k: U for k in UPDATE}, "ema": 1}
    N = t.args.n_agents
    assert s["counters"] == {"rollout.chip_steps": B * T,
                             "learn.rows": U * t.args.batch_size * (T + 1) * N,
                             "learn.unroll.sequence": 2 * U}
    for v in s["spans"].values():
        assert 0 <= v["self_ms"] <= v["host_ms"] and v["device_ms"] is None


def test_farm_cycle_has_the_spans_in_their_parents(tmp_path):
    args = make_args(tmp_path, n_parallel_envs=4, batch_size=4)
    farm = SeedFarm(make_env_from_args(args), args, 2)
    farm.train_cycle()
    tracing.enable()
    farm.train_cycle()
    tracing.disable()
    T, U = args.episode_limit, farm.updates_per_rollout
    check_cycle(tracing.records(), T, U)
    c = tracing.summary()["counters"]
    assert c == {"rollout.chip_steps": 2 * 4 * T,
                 "learn.rows": 2 * U * 4 * (T + 1) * args.n_agents,
                 "learn.unroll.stepwise": 2 * U}


def test_off_records_nothing_and_enters_no_range(tmp_path, monkeypatch):
    t = trainer(make_args(tmp_path))
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: entered.append(
        "event"))
    assert not tracing.TRACER.enabled
    t.train_cycle()
    assert tracing.records() == [] and entered == []
    assert tracing.summary() == {"spans": {}, "counters": {}, "cycles": 0}


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_results_are_bitwise_equal_on_and_off(how, tmp_path):
    off, on = (trainer(make_args(tmp_path / d)) for d in ("off", "on"))
    off.train_cycle()
    if how == "enable":
        tracing.enable()
        on.train_cycle()
        tracing.disable()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            on.train_cycle()
    assert tracing.summary()["spans"]["train_cycle"]["calls"] == 1
    assert_equal(state_of(off), state_of(on))


def test_profiler_session_records_ranges_and_a_fresh_record(tmp_path):
    t = trainer(make_args(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.train_cycle()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    want = {"train_cycle", "rollout", "rollout.reset", *ROLLOUT_STEP,
            "rollout.pack", "store", "learn_many", *UPDATE, "ema"}
    assert {tracing.PREFIX + n for n in want} <= names
    first = tracing.summary()
    assert first["spans"]["train_cycle"]["calls"] == 1
    assert not tracing.TRACER.enabled
    t.train_cycle()                   # off again: nothing is added
    assert tracing.summary() == first
    with profile(activities=[ProfilerActivity.CPU]):
        t.rollout(t.env_states, t.generator, 0.0, 0.0, 0.0, greedy=True)
    second = tracing.summary()
    assert set(second["spans"]) == {"rollout", "rollout.reset",
                                    *ROLLOUT_STEP, "rollout.pack"}
    assert second["counters"] == {
        "rollout.chip_steps": t.B * t.args.episode_limit}


def test_summary_self_time_and_open_spans():
    tracing.enable()
    with tracing.span("outer"):
        time.sleep(0.01)
        with tracing.span("inner"):
            time.sleep(0.02)
        with tracing.span("inner"):
            time.sleep(0.02)
        tracing.count("things", 3)
        tracing.count("things", 4)
        with tracing.span("open"):
            half = tracing.summary()
    with tracing.span("second"):
        pass
    tracing.disable()
    assert "outer" not in half["spans"] and "open" not in half["spans"]
    s = tracing.summary()
    outer, inner = s["spans"]["outer"], s["spans"]["inner"]
    assert inner["calls"] == 2 and inner["host_ms"] >= 40
    assert outer["host_ms"] >= inner["host_ms"] + 10
    assert outer["self_ms"] == pytest.approx(
        outer["host_ms"] - inner["host_ms"] - s["spans"]["open"]["host_ms"])
    assert s["counters"] == {"things": 7} and s["cycles"] == 2
    with tracing.span("after"):   # disabled: not recorded
        pass
    assert "after" not in tracing.summary()["spans"]


def test_farm_gradients_equal_the_vmapped_grad_and_value(tmp_path):
    """The farm's update takes the vector-Jacobian product of its vmapped
    losses (a forward, then a backward); it equals ``vmap`` of
    ``grad_and_value`` bitwise on VDN."""
    args = make_args(tmp_path, n_parallel_envs=4, batch_size=4)
    farm = SeedFarm(make_env_from_args(args), args, 2)
    farm.train_cycle()
    L = farm.learner
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    idx = torch.stack([torch.randint(0, farm.replay.size, (4,), generator=g)
                       for g in gens])
    batch = sample_stacked(farm.replay, idx)
    loss, grads = L.loss_and_grads(batch)
    want_g, want_loss = torch.func.vmap(torch.func.grad_and_value(
        functional_loss(L.loss_module)))(L.params, L.target_params, batch)
    assert torch.equal(loss, want_loss)
    assert_equal(grads, want_g)


@pytest.mark.parametrize("kw, path", [
    ({}, "sequence"),
    ({"remat": True}, "stepwise"),
    ({"fused_streams": True}, "stepwise"),
    ({"compute_dtype": "bf16"}, "stepwise"),
    ({"vmap_seeds": 2}, "stepwise"),
], ids=["float32", "remat", "fused_streams", "bf16", "farm"])
def test_update_counts_its_unrolls_by_path(kw, path, tmp_path):
    """An update unrolls two streams, eval and target: a float32 agent's
    both by the sequence branch; under ``--remat``, ``--fused_streams``
    (one unroll of the two streams' stacked parameters), bf16 and the seed
    farm's vmapped update both by the stepwise loop."""
    args = make_args(tmp_path, **kw)
    if args.vmap_seeds:
        farm = SeedFarm(make_env_from_args(args), args, args.vmap_seeds)
        farm.train_cycle()
        learner, replay = farm.learner, farm.replay
        idx = torch.zeros((1, args.vmap_seeds, args.batch_size),
                          dtype=torch.long)
    else:
        t = trainer(args)
        learner, replay = t.learner, t.replay
        idx = torch.zeros((1, args.batch_size), dtype=torch.long)
    tracing.enable()
    learner.learn_many(replay, 1, None, idx)
    tracing.disable()
    c = tracing.summary()["counters"]
    other = {"sequence": "stepwise", "stepwise": "sequence"}[path]
    assert c["learn.unroll." + path] == 2
    assert "learn.unroll." + other not in c


@pytest.mark.parametrize("seeds", [0, 2], ids=["trainer", "farm"])
def test_profile_dir_writes_the_trace_and_the_spans(seeds, tmp_path):
    out = tmp_path / "profile"
    train.main(["dmfb", "--drop_num=2", "--fov=5", "--chip_size=5",
                "--n_parallel_envs=4", "--buffer_size=32", "--batch_size=8",
                "--exact_steps=300", "--evaluate_cycle=200",
                "--evaluate_task=4", f"--vmap_seeds={seeds}", "--device=cpu",
                "--mesh=off", f"--data_dir={tmp_path / 'run'}",
                f"--profile_dir={out}"])
    names = {e.get("name") for e in json.loads(
        (out / "trace.json").read_text())["traceEvents"]}
    assert {"marl.train_cycle", "marl.rollout.env_step",
            "marl.learn.backward"} <= names
    spans = json.loads((out / "spans.json").read_text())
    assert spans["spans"]["train_cycle"]["calls"] == 1
    assert spans["cycles"] == 1 and spans["counters"]["learn.rows"] > 0


@pytest.mark.cuda
def test_cuda_spans_time_the_device(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    t = trainer(make_args(tmp_path, device="cuda"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t.train_cycle()
    s = tracing.summary()["spans"]
    for name, v in s.items():
        assert v["device_ms"] is not None and v["device_ms"] > 0, name
    assert s["rollout"]["device_ms"] >= sum(
        s[k]["device_ms"] for k in ROLLOUT_STEP) * 0.99


@pytest.mark.parametrize("conf", [DMFB, MEDA], ids=["dmfb", "meda"])
def test_qmix_cycle_has_the_mix_and_state_spans(conf, tmp_path):
    """Under QMIX each update's two mixer calls are one ``learn.mix`` inside
    its ``learn.forward``, counted by ``learn.mix.rows`` (b T rows a call),
    and each global state of the rollout a ``rollout.state``: the first
    before the steps, the others inside their steps' records.  Under VDN
    there is neither."""
    qmix, vdn = (trainer(make_args(tmp_path / alg, conf, alg=alg))
                 for alg in ("qmix", "vdn"))
    for t in (qmix, vdn):
        tracing.enable()
        t.train_cycle()
        tracing.disable()
        recs, s = tracing.records(), tracing.summary()
        names = {r["name"] for r in recs}
        if t is vdn:
            assert not names & {"learn.mix", "rollout.state"}
            assert "learn.mix.rows" not in s["counters"]
            continue
        T, U = t.args.episode_limit, t.updates_per_rollout
        b = t.args.batch_size
        assert s["spans"]["learn.mix"]["calls"] == U
        assert s["spans"]["rollout.state"]["calls"] == T + 1
        assert s["counters"]["learn.mix.rows"] == U * 2 * b * T
        parent = {i: recs[r["parent"]]["name"] for i, r in enumerate(recs)
                  if r["parent"] is not None}
        assert {parent[i] for i, r in enumerate(recs)
                if r["name"] == "learn.mix"} == {"learn.forward"}
        states = [i for i, r in enumerate(recs)
                  if r["name"] == "rollout.state"]
        assert parent[states[0]] == "rollout"
        assert {parent[i] for i in states[1:]} == {"rollout.record"}
        rollout = recs.index(next(r for r in recs if r["name"] == "rollout"))
        assert [r["name"] for r in children(recs, rollout)][:2] == [
            "rollout.reset", "rollout.state"]


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_qmix_results_are_bitwise_equal_on_and_off(how, tmp_path):
    off, on = (trainer(make_args(tmp_path / d, MEDA, alg="qmix"))
               for d in ("off", "on"))
    off.train_cycle()
    if how == "enable":
        tracing.enable()
        on.train_cycle()
        tracing.disable()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            on.train_cycle()
    assert tracing.summary()["spans"]["learn.mix"]["calls"] >= 1
    assert_equal(state_of(off), state_of(on))
