"""The port's Trainer (``marl_dmfb_tpu_torch/trainer.py``) and checkpoints
(``checkpoint.py``) on the CPU: a run writes checkpoints and ``.npy``
curves; save -> load is bitwise and a resumed run is the uninterrupted one;
loading is strict by name; a resume with another ``--param_ema`` or
``--ckpt_replay`` raises; the epsilon schedules; TF32 is off wherever a net
is built.  On a machine with a card (``cuda``-marked): TF32 is off without
the CLI, and the learner on the card agrees with the CPU.

No JAX here, so that the card's machine can run the ``cuda`` tests:
``python -m pytest --noconftest -m cuda tests/test_torch_trainer.py``.
"""

import os

import numpy as np
import pytest
import torch

from marl_dmfb_tpu_torch import checkpoint
from marl_dmfb_tpu_torch.algos.qlearn import QLearner
from marl_dmfb_tpu_torch.config import Args
from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.models.networks import build_agent_net, init_params
from marl_dmfb_tpu_torch.rollout import make_rollout
from marl_dmfb_tpu_torch.trainer import Trainer

torch.set_num_threads(1)

# 5x5 board, 2 droplets, fov 5 (T = 20), GRU hidden 16, 8 conv channels;
# 4 chips a rollout and 2 updates a cycle on minibatches of 4 episodes
SMALL = dict(name="dmfb", drop_num=2, fov=5, width=5, length=5,
             batch_size=4, buffer_size=8, n_parallel_envs=4,
             rnn_hidden_dim=16, hyper_hidden_dim=8, target_update_cycle=2,
             evaluate_task=4)


def small(tmp_path, device="cpu", **kw) -> Args:
    return Args(**{**SMALL, **kw}, device=device, data_dir=str(tmp_path))


def trainer(args) -> Trainer:
    env = make_env("dmfb", width=args.width, length=args.length,
                   n_droplets=args.drop_num, fov=args.fov)
    return Trainer(env, args)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    else:
        yield prefix, tree


def assert_trees_equal(a, b):
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    for k, x in la.items():
        y = lb[k]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y.cpu()), k
        else:
            assert x == y, k


def test_run_writes_checkpoints_and_curves(tmp_path):
    args = small(tmp_path, n_steps=150, evaluate_cycle=60)
    t = trainer(args)
    out = t.run()
    model_dir = tmp_path / "model" / "vdn" / "fov5"
    saved = sorted(os.listdir(model_dir))
    n_evals = len(out["success_rate"])
    assert n_evals >= 3                       # at 0 steps, mid-run, final
    assert saved == sorted([f"0_{i}_state.pt" for i in range(n_evals - 1)]
                           + ["0_final_state.pt"])
    curves = tmp_path / "TrainResult" / "vdn" / "fov5" / "5by5-2d0b"
    prefix = "vdn_env(5,5,2,0,5,True)"
    for name in ("Rewards", "steps", "constraints", "success_rate",
                 "runtime"):
        series = np.load(curves / f"{prefix}{name}_0.npy")
        assert series.shape == (n_evals,), name
    assert len(out["loss"]) == t.n_cycles and np.isfinite(out["loss"]).all()
    assert t.learner.train_step == 2 * t.n_cycles
    assert t.replay.size == min(8, 4 * t.n_cycles)


def test_offline_evaluation_scores_every_checkpoint(tmp_path):
    """With ``--online_eval`` off, the run ends by reloading each saved
    checkpoint (params only) and evaluating it (reference
    train.py:96-118)."""
    t = trainer(small(tmp_path, n_steps=150, evaluate_cycle=60))
    out = t.run(online_evaluate=False)
    saved = os.listdir(tmp_path / "model" / "vdn" / "fov5")
    assert len(out["success_rate"]) == len(saved) >= 3


def test_evaluate_reads_the_net_config_of_a_checkpoint(tmp_path):
    """A checkpoint of a narrow net (GRU 16, 8 conv channels) evaluates
    through the evaluate entry point, whose own defaults are the 4-droplet
    widths (GRU 128, 24 channels): the checkpoint's net_config wins."""
    from marl_dmfb_tpu_torch import evaluate

    t = trainer(small(tmp_path))
    t.train_cycle()
    t.save_model("final")
    m = evaluate.main(["dmfb", "--drop_num=2", "--chip_size=5", "--fov=5",
                       "--evaluate_task=4", "--device=cpu", "--load_model",
                       f"--data_dir={tmp_path}"])
    assert 0 < m["steps"] <= 20


@pytest.mark.parametrize("kw", [dict(), dict(param_ema=0.9, ckpt_replay=True)],
                         ids=["default", "ema_and_replay"])
def test_save_load_is_bitwise(tmp_path, kw):
    a = trainer(small(tmp_path, **kw))
    a.train_cycle()
    a.train_cycle()
    a.save_model("mid")
    b = trainer(small(tmp_path, seed=99, **kw))
    b.load_model("mid")
    assert_trees_equal(a._tree(), b._tree())
    if kw:
        # everything that decides the next cycle was restored: a resumed
        # run is the uninterrupted one
        a.train_cycle()
        b.train_cycle()
        assert_trees_equal(a._tree(), b._tree())


def _mutate(tree, how):
    agent = tree["learner"]["params"]["agent"]
    if how == "missing":
        del agent["fc1.bias"]
    elif how == "extra":
        tree["learner"]["opt_state"]["schedule_count"] = torch.tensor(0)
    else:
        agent["fc1.bias"] = torch.zeros(7)


@pytest.mark.parametrize("how,match", [
    ("missing", "no entry for 'learner/params/agent/fc1.bias'"),
    ("extra", r"entries this trainer's state does not: "
              r"\['learner/opt_state/schedule_count'\]"),
    ("shape", "leaf 'learner/params/agent/fc1.bias' shape mismatch"),
])
def test_load_is_strict_by_name(tmp_path, how, match):
    t = trainer(small(tmp_path))
    path = t.save_model("x")
    tree = checkpoint.load(path)
    _mutate(tree, how)
    checkpoint.save(path, tree)
    with pytest.raises(ValueError, match=match):
        t.load_model("x")


@pytest.mark.parametrize("flag,saved,resumed", [
    ("param_ema", 0.9, 0.0), ("param_ema", 0.0, 0.9),
    ("ckpt_replay", True, False), ("ckpt_replay", False, True)])
def test_resume_with_other_flags_raises(tmp_path, flag, saved, resumed):
    trainer(small(tmp_path, **{flag: saved})).save_model("x")
    t = trainer(small(tmp_path, **{flag: resumed}))
    on = lambda v: "on" if v else "off"
    with pytest.raises(ValueError, match=f"saved with --{flag} {on(saved)}, "
                       f"and this run has it {on(resumed)}"):
        t.load_model("x")


def test_params_only_load_takes_the_ema(tmp_path):
    """Evaluation restores the EMA params where the checkpoint has them,
    and drops the live EMA, so that it scores the checkpoint's weights."""
    a = trainer(small(tmp_path, param_ema=0.9))
    a.train_cycle()
    ema = {k: v.detach().clone() for k, v in a.ema_net.named_parameters()}
    live = dict(a.net.named_parameters())
    assert not torch.equal(ema["fc1.weight"], live["fc1.weight"])
    a.save_model("e")
    a.load_model("e", params_only=True)
    assert a.ema_net is None
    for k, p in a.net.named_parameters():
        assert torch.equal(p, ema[k]), k
    for k, p in a.learner.target_net.named_parameters():
        assert torch.equal(p, ema[k]), k


def test_episode_epsilon_schedule_is_clamped(tmp_path):
    t = trainer(small(tmp_path, epsilon_anneal_scale="episode",
                      anneal_steps=10))
    assert t.anneal_per_step == 0.0
    t.train_cycle()
    assert t.epsilon == pytest.approx(1.0 - 4 * 0.95 / 10, abs=1e-7)
    t.train_cycle()
    t.train_cycle()
    assert t.epsilon == pytest.approx(0.05, abs=1e-7)


def test_step_epsilon_schedule_follows_the_rollout(tmp_path):
    t = trainer(small(tmp_path, anneal_steps=1000))
    t.train_cycle()
    # 4 chips a step, so at most 4 * 20 schedule steps of 0.95 / 1000
    assert 1.0 - 80 * 0.95 / 1000 - 1e-6 <= float(t.epsilon) < 1.0


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _tf32_off() -> bool:
    return (not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32)


def _build(what, args):
    env = make_env("dmfb", width=args.width, length=args.length,
                   n_droplets=args.drop_num, fov=args.fov)
    args.update_env_info(env.env_info())
    net = build_agent_net(args).to(args.device)
    if what == "trainer":
        Trainer(env, args)
    elif what == "learner":
        QLearner(args, net)
    else:
        make_rollout(env, net, args.rnn_hidden_dim)


@pytest.mark.parametrize("what", ["trainer", "learner", "rollout"])
def test_building_a_net_user_turns_tf32_off(tmp_path, what):
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    _tf32_on()
    try:
        _build(what, small(tmp_path))
        assert _tf32_off()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


@pytest.mark.cuda
def test_cuda_trainer_and_learner_turn_tf32_off(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for what in ("trainer", "learner"):
        _tf32_on()
        _build(what, small(tmp_path, device="cuda"))
        assert _tf32_off(), what


@pytest.mark.cuda
def test_cuda_learner_matches_cpu(tmp_path):
    """Three updates of the same learner state on the same minibatches, on
    the card and on the CPU, with TF32 off.  Tolerances: the loss rtol 1e-5
    (other summation orders over 20 steps of 4 * 2 rows); the params atol
    1e-5, except elements whose CPU gradient is within 1e-6 of the
    gradient's norm of zero, which Adam may move by up to a learning rate
    in either direction (2 * lr * updates)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = small(tmp_path)
    env = make_env("dmfb", width=5, length=5, n_droplets=2, fov=5)
    args.update_env_info(env.env_info())
    net = init_params(build_agent_net(args), torch.Generator().manual_seed(3))
    cpu = QLearner(args, net)
    card = QLearner(args, build_agent_net(args).cuda())
    card.load_state(cpu.state())
    rng = np.random.RandomState(0)
    noisy = {k: torch.zeros(v.shape, dtype=torch.bool)
             for k, v in cpu.params.items()}
    for k in range(3):
        lens = rng.randint(1, 21, size=4)
        t = np.arange(20)[None]
        pad = t >= lens[:, None]
        batch = {
            "o_ext": torch.from_numpy(rng.randint(
                -1, 3, (4, 21, 2, 77)).astype(np.int8)),
            "u": torch.from_numpy(np.where(pad[..., None], 0, rng.randint(
                0, 5, (4, 20, 2))).astype(np.int8)[..., None]),
            "r": torch.from_numpy(np.where(pad, 0, rng.randn(4, 20)).astype(
                np.float32)[..., None]),
            "padded": torch.from_numpy(pad[..., None]),
            "terminated": torch.from_numpy((t >= lens[:, None] - 1)[..., None]),
        }
        _, grads = cpu.loss_and_grads(batch)
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        for n, g in grads.items():
            noisy[n] |= g.abs() <= 1e-6 * norm
        want = cpu.update(batch)
        got = card.update({n: v.cuda() for n, v in batch.items()})
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=0)
        bound = 2 * args.lr * (k + 1)
        for n, p in cpu.params.items():
            diff = (card.params[n].detach().cpu() - p.detach()).abs()
            kept = diff[~noisy[n]]
            assert not kept.numel() or float(kept.max()) <= 1e-5, n
            assert float(diff.max()) <= bound, n
