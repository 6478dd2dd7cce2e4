"""The port's seed farm (``marl_dmfb_tpu_torch/parallel/seedfarm.py``) on
the CPU, at the JAX farm test's size (``tests/test_seedfarm.py``: 5x5, 2
droplets, fov 5, 4 chips a rollout, minibatches of 8, rings of 32, two
seeds): seed i of the farm against the port's ``Trainer(seed + i)`` over
one cycle and over several, the EMA run's curves and per-seed checkpoints,
a bitwise resume under ``--ckpt_replay``, the resume's refusals, the CLI,
and the stacked GRU cell and convolution against the per-seed modules.  On
a machine with a card (``cuda``-marked): one ``dmfb_step`` launch per step
of a farm rollout at batch S*B, bitwise equal to the plain step, the farm
on the card against single seeds on the card, and the shim on the card
against the CPU.

Tolerances (float32): after one cycle, seed i's params equal the
Trainer's within rtol 1e-6 and atol 1e-8, and its epsilon exactly; after
three or more cycles, within rtol 1e-4 and atol 1e-6 (the JAX farm test's
two tolerances).  The farm's batched products and grouped convolutions sum
in another order than one seed's, and Adam's ``g / (|g| + 1e-8)`` turns the
float32 difference of a near-zero gradient into up to a learning rate:
elements whose gradient in the Trainer was within 1e-6 of the gradient's
global norm of zero at some update are held to ``2 * lr * updates``
instead, as ``tests/torch_learn_util.py`` holds the learner to JAX's.  The
stacked GRU cell and convolution equal the per-seed modules within atol
1e-6 (outputs of order 1).

No JAX here, so that the card's machine can run the ``cuda`` tests:
``python -m pytest --noconftest -m cuda tests/test_torch_seedfarm.py``.
"""

import glob
import os

import numpy as np
import pytest
import torch

from marl_dmfb_tpu_torch import checkpoint, train
from marl_dmfb_tpu_torch.config import Args, make_env_from_args
from marl_dmfb_tpu_torch.models.networks import (StackedNet, TorchConv,
                                                 TorchGRUCell,
                                                 build_agent_net, init_params)
from marl_dmfb_tpu_torch.parallel import seedfarm
from marl_dmfb_tpu_torch.trainer import Trainer

torch.set_num_threads(1)

S = 2
MODULE_ATOL = 1e-6
NOISE = 1e-6     # a gradient within NOISE * its global norm of zero


def farm_args(tmp_path, device="cpu", **kw) -> Args:
    """The JAX farm test's configuration (``tests/test_seedfarm.py``)."""
    a = Args(name="dmfb", alg="vdn", drop_num=2, fov=5, width=5, length=5,
             evaluate_task=4, evaluate_cycle=400, n_steps=700,
             data_dir=str(tmp_path), device=device)
    a.load_hparams()
    a.batch_size, a.buffer_size, a.n_parallel_envs = 8, 32, 4
    a.anneal_steps = 500
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def run(args, n_steps):
    args.n_steps = n_steps
    return seedfarm.run_farm(args, make_env_from_args(args), S)


def seed_checkpoint(root, i, alg="vdn"):
    """Seed ``i``'s final checkpoint of the farm run under ``root``."""
    return checkpoint.load(os.path.join(str(root), "model", alg, "fov5",
                                        f"{i}_final_state.pt"))


def record_noise(trainer: Trainer) -> dict:
    """Mark, as ``trainer``'s learner updates, each parameter element whose
    gradient is float noise at some update: within ``NOISE`` times the
    gradient's global norm of zero (``tests/torch_learn_util.py``'s rule).
    Returns the masks, keyed as ``QLearner.all_params``."""
    learner = trainer.learner
    noisy = {k: torch.zeros(v.shape, dtype=torch.bool, device=v.device)
             for k, v in learner.all_params.items()}
    plain = learner.loss_and_grads

    def recording(batch):
        loss, grads = plain(batch)
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values()))
        for k, g in grads.items():
            noisy[k] |= g.abs() <= NOISE * norm
        return loss, grads

    learner.loss_and_grads = recording
    return noisy


def assert_params_close(saved: dict, trainer: Trainer, noisy: dict, rtol,
                        atol, what):
    """Params and target params within ``rtol``/``atol``, except elements
    ``noisy`` marks, which Adam may move by up to a learning rate either
    way in either program: those within ``2 * lr * updates``."""
    live = checkpoint.to_cpu(trainer.learner.state())
    wide = 2 * trainer.args.lr * trainer.learner.train_step
    for key in ("params", "target_params"):
        for part, d in live[key].items():
            for k, v in d.items():
                got = saved["learner"][key][part][k].numpy()
                want = v.numpy()
                name = ("mixer." if part == "mixer" else "") + k
                off = ~np.isclose(got, want, rtol=rtol, atol=atol)
                clean = off & ~noisy[name].cpu().numpy()
                assert not clean.any(), (
                    f"{what}: {key}/{part}/{k}: {int(clean.sum())} elements "
                    f"differ by up to {np.abs(got - want)[clean].max():.3g}")
                assert np.abs(got - want).max() <= max(atol, wide), (
                    f"{what}: {key}/{part}/{k}: a noise-gradient element "
                    "moved too far")


@pytest.mark.parametrize("kw", [
    {},
    {"epsilon_anneal_scale": "episode"},
    {"alg": "qmix", "qmix_hidden_dim": 8},
], ids=["vdn", "episode-epsilon", "qmix"])
def test_farm_cycle_matches_independent_trainers(tmp_path, kw):
    """Farm seed i's first cycle is ``Trainer(seed + i)``'s: the same draws
    (the farm's evaluations take their own stream), params within rtol
    1e-6 and atol 1e-8, epsilon exactly."""
    singles = []
    for i in range(S):
        a = farm_args(tmp_path / f"s{i}", seed=12 + i, **kw)
        t = Trainer(make_env_from_args(a), a)
        noisy = record_noise(t)
        t.train_cycle()
        singles.append((t, noisy))
    # one cycle collects 4 episodes of at most 20 steps, so a budget of 1
    # step runs exactly one; the evaluations do not touch the training draws
    curves = run(farm_args(tmp_path / "farm", seed=12, **kw), 1)
    assert curves["success_rate"].shape == (S, 2)
    for i, (t, noisy) in enumerate(singles):
        saved = seed_checkpoint(tmp_path / "farm", i, kw.get("alg", "vdn"))
        assert_params_close(saved, t, noisy, 1e-6, 1e-8, f"seed {i}")
        assert saved["epsilon"].item() == float(t.epsilon)
        assert int(saved["learner"]["train_step"]) == t.learner.train_step
        for k, v in t.learner.state()["opt_state"].items():
            if not isinstance(v, dict):
                assert int(saved["learner"]["opt_state"][k]) == int(v), k


def test_farm_multicycle_matches_trainers(tmp_path):
    """Beyond the first cycle the farm stays draw for draw with S
    Trainers: the same number of cycles (the farm stops on the mean steps
    over the seeds, and so do the singles here), params within rtol 1e-4
    and atol 1e-6, and both parameter sets score alike under one evaluation
    protocol (``eval_only`` Trainers of one seed)."""
    budget = 300
    singles = [Trainer(make_env_from_args(a), a) for a in
               (farm_args(tmp_path / f"s{i}", seed=12 + i) for i in range(S))]
    noisy = [record_noise(t) for t in singles]
    steps, cycles = np.zeros(S), 0
    while steps.mean() < budget:
        for i, t in enumerate(singles):
            steps[i] += t.train_cycle()
        cycles += 1
    assert cycles >= 3, f"the budget gave only {cycles} cycles"
    run(farm_args(tmp_path / "farm", seed=12, evaluate_cycle=10 ** 9), budget)
    for i, t in enumerate(singles):
        saved = seed_checkpoint(tmp_path / "farm", i)
        assert_params_close(saved, t, noisy[i], 1e-4, 1e-6,
                            f"seed {i}, {cycles} cycles")
        np.testing.assert_allclose(saved["epsilon"].item(), float(t.epsilon),
                                   rtol=1e-6)
        t.save_model("single")
        scores = {}
        for name, root, run_i, tag in (("farm", tmp_path / "farm", i,
                                        "final"),
                                       ("single", tmp_path / f"s{i}", 0,
                                        "single")):
            a = farm_args(root, seed=12, ith_run=run_i)
            ev = Trainer(make_env_from_args(a), a, eval_only=True)
            ev.load_model(tag, params_only=True)
            scores[name] = ev.evaluate()
        for key in ("success_rate", "steps"):
            np.testing.assert_allclose(scores["farm"][key],
                                       scores["single"][key], rtol=1e-6,
                                       err_msg=f"seed {i} {key}")


def test_farm_ema_run_writes_curves_and_seed_checkpoints(tmp_path):
    """A ``--param_ema`` farm writes the stacked curve and each seed's
    curves and checkpoints, which ``Trainer.load_model(params_only=True)``
    evaluates."""
    curves = run(farm_args(tmp_path, seed=12, param_ema=0.9), 300)
    assert curves["success_rate"].shape[0] == S
    assert curves["success_rate"].shape[1] >= 2
    farm_npy = glob.glob(str(tmp_path / "TrainResult" / "vdn" / "fov5" / "*"
                             / "*success_rate_farm.npy"))
    assert len(farm_npy) == 1
    np.testing.assert_array_equal(np.load(farm_npy[0]),
                                  curves["success_rate"])
    for i in range(S):
        seed_npy = farm_npy[0].replace("_farm.npy", f"_{i}.npy")
        np.testing.assert_array_equal(np.load(seed_npy),
                                      curves["success_rate"][i])
        saved = seed_checkpoint(tmp_path, i)
        assert "ema" in saved
        a = farm_args(tmp_path, seed=12, ith_run=i, param_ema=0.9)
        t = Trainer(make_env_from_args(a), a, eval_only=True)
        t.load_model("final", params_only=True)
        for k, v in t.net.named_parameters():
            assert torch.equal(v, saved["ema"]["agent"][k]), k
        m = t.evaluate()
        assert 0.0 <= m["success_rate"] <= 1.0


def test_farm_resume_continues_bitwise(tmp_path):
    """A farm stopped after its evaluation checkpoints and resumed with
    ``--load_model`` reproduces an uninterrupted run's curves bitwise under
    ``--ckpt_replay``; at most the two newest resume checkpoints stay."""
    kw = dict(evaluate_cycle=120, ckpt_replay=True, seed=12)
    full = run(farm_args(tmp_path / "full", **kw), 400)
    run(farm_args(tmp_path / "res", **kw), 250)   # stopped early, >= 2 evals
    mdir = str(tmp_path / "res" / "model" / "vdn" / "fov5")
    assert 1 <= len(seedfarm.resume_tags(mdir)) <= 2
    resumed = run(farm_args(tmp_path / "res", load_model=True, **kw), 400)
    for name in ("success_rate", "steps", "Rewards", "constraints"):
        assert resumed[name].shape == full[name].shape, name
        np.testing.assert_array_equal(resumed[name], full[name], name)
    assert len(seedfarm.resume_tags(mdir)) == 2
    for i in range(S):
        a = seed_checkpoint(tmp_path / "full", i)
        b = seed_checkpoint(tmp_path / "res", i)
        for k, v in a["learner"]["params"]["agent"].items():
            assert torch.equal(v, b["learner"]["params"]["agent"][k]), k


def test_farm_resume_falls_back_to_an_older_checkpoint(tmp_path):
    """An unreadable newest resume checkpoint is passed over for the one
    before it."""
    kw = dict(evaluate_cycle=120, seed=12)
    run(farm_args(tmp_path, **kw), 250)
    mdir = str(tmp_path / "model" / "vdn" / "fov5")
    tags = seedfarm.resume_tags(mdir)
    assert len(tags) == 2
    with open(os.path.join(mdir, f"farm_{tags[-1]}_resume.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    a = farm_args(tmp_path, load_model=True, **kw)
    a.n_steps = 250
    farm = seedfarm.SeedFarm(make_env_from_args(a), a, S)
    farm.load_farm()
    assert farm.evaluate_steps == tags[0]
    assert len(farm.curves["success_rate"]) == tags[0] + 1


def test_farm_resume_requires_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="farm_<E>_resume"):
        run(farm_args(tmp_path, seed=12, load_model=True), 100)


@pytest.mark.parametrize("flag,saved,resumed", [
    ("param_ema", 0.0, 0.9), ("param_ema", 0.9, 0.0),
    ("ckpt_replay", False, True), ("ckpt_replay", True, False),
])
def test_farm_resume_with_other_flags_raises(tmp_path, flag, saved, resumed):
    """A resume with another ``--param_ema`` or ``--ckpt_replay`` than the
    checkpoint's raises ``ValueError`` that names the flag as this run has
    it (the two flaws ``ADVICE.md`` found in the JAX farm)."""
    run(farm_args(tmp_path, seed=12, evaluate_cycle=120, **{flag: saved}),
        130)
    on = lambda v: "on" if v else "off"
    with pytest.raises(ValueError, match=(
            f"saved with --{flag} {on(saved)}, and this run has it "
            f"{on(resumed)}")):
        run(farm_args(tmp_path, seed=12, evaluate_cycle=120,
                      load_model=True, **{flag: resumed}), 260)


def test_train_cli_runs_a_farm(tmp_path):
    farm = train.main(["dmfb", "--drop_num=2", "--fov=5", "--chip_size=5",
                       "--vmap_seeds=2", "--n_parallel_envs=4",
                       "--batch_size=8", "--buffer_size=32",
                       "--exact_steps=100", "--evaluate_task=4",
                       "--device=cpu", f"--data_dir={tmp_path}"])
    assert isinstance(farm, seedfarm.SeedFarm) and farm.S == 2
    assert farm.n_cycles >= 1
    assert os.path.isfile(tmp_path / "model" / "vdn" / "fov5"
                          / "1_final_state.pt")


def test_farm_with_a_mesh_exits(tmp_path):
    with pytest.raises(SystemExit, match="--vmap_seeds runs on one device"):
        train.main(["dmfb", "--vmap_seeds=2", "--mesh=2", "--device=cpu",
                    f"--data_dir={tmp_path}"])


def test_remat_farm_raises_naming_the_roadmap_entry(tmp_path):
    """The farm takes ``--remat`` (its recomputation is an
    ``autograd.Function`` that ``torch.func.grad`` and ``vmap`` take,
    ``algos/qlearn.py:checkpoint``), and two cycles give the losses and
    parameters of the farm without it, bitwise: the recomputation runs the
    same operations on the same inputs.  (JAX's farm with ``--remat``:
    ``tests/test_torch_seedfarm_learner.py``.)"""
    farms = []
    for remat in (False, True):
        a = farm_args(tmp_path / str(remat), seed=12, remat=remat)
        farm = seedfarm.SeedFarm(make_env_from_args(a), a, S)
        for _ in range(2):
            farm.train_cycle()
        farms.append(farm)
    plain, remat = farms
    assert remat.learner.args.remat
    assert torch.equal(torch.stack(plain.losses), torch.stack(remat.losses))
    for k, v in plain.learner.params.items():
        assert torch.equal(v, remat.learner.params[k]), k


# ---------------------------------------------------------------------------
# the stacked modules against the per-seed ones
# ---------------------------------------------------------------------------


def _nets(args, n):
    nets = []
    for i in range(n):
        nets.append(init_params(build_agent_net(args),
                                torch.Generator().manual_seed(i)))
    return nets


@pytest.mark.parametrize("net", ["crnn", "rnn"])
def test_stacked_net_matches_per_seed_nets(tmp_path, net):
    """``StackedNet`` (vmap over stacked parameters, the GRU cell in its
    stacked form) equals each seed's own net on its rows."""
    a = farm_args(tmp_path, net=net, rnn_hidden_dim=32, hyper_hidden_dim=8)
    a.update_env_info(make_env_from_args(a).env_info())
    nets = _nets(a, 3)
    params = {k: torch.stack([dict(m.named_parameters())[k].detach()
                              for m in nets])
              for k, _ in nets[0].named_parameters()}
    stacked = StackedNet(build_agent_net(a), params, 3)
    g = torch.Generator().manual_seed(3)
    rows = 24
    x = torch.randint(-1, 3, (3 * rows, a.obs_shape[-1] + a.n_actions),
                      generator=g).float()
    h = torch.randn((3 * rows, 32), generator=g)
    with torch.no_grad():
        q, h2 = stacked(x, h)
        for i, m in enumerate(nets):
            sl = slice(i * rows, (i + 1) * rows)
            qi, hi = m(x[sl], h[sl])
            np.testing.assert_allclose(q[sl].numpy(), qi.numpy(), rtol=0,
                                       atol=MODULE_ATOL)
            np.testing.assert_allclose(h2[sl].numpy(), hi.numpy(), rtol=0,
                                       atol=MODULE_ATOL)


def test_stacked_gru_cell_matches_the_fused_cell():
    """The GRU cell's stacked form under vmap equals torch's fused cell per
    seed (and batches: no per-seed fallback for ``aten::gru_cell``)."""
    cells = [TorchGRUCell(12, 16) for _ in range(3)]
    g = torch.Generator()
    for i, c in enumerate(cells):
        init_params(c, g.manual_seed(i))
    params = {k: torch.stack([dict(c.named_parameters())[k].detach()
                              for c in cells])
              for k, _ in cells[0].named_parameters()}
    template = TorchGRUCell(12, 16)
    template.stacked = True
    x = torch.randn((3, 10, 12), generator=g)
    h = torch.randn((3, 10, 16), generator=g)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a batching-rule fallback warns
        out = torch.func.vmap(lambda p, a, b: torch.func.functional_call(
            template, p, (a, b)))(params, x, h)
    for i, c in enumerate(cells):
        with torch.no_grad():
            np.testing.assert_allclose(out[i].detach().numpy(),
                                       c(x[i], h[i]).numpy(), rtol=0,
                                       atol=MODULE_ATOL)


def test_stacked_conv_matches_per_seed_convs():
    """A 3x3 convolution under vmap over stacked weights (a grouped
    convolution) equals each seed's own."""
    convs = [TorchConv(3, 8) for _ in range(3)]
    g = torch.Generator()
    for i, c in enumerate(convs):
        init_params(c, g.manual_seed(i))
    params = {k: torch.stack([dict(c.named_parameters())[k].detach()
                              for c in convs])
              for k, _ in convs[0].named_parameters()}
    x = torch.randint(-1, 3, (3, 20, 3, 9, 9), generator=g).float()
    template = TorchConv(3, 8)
    out = torch.func.vmap(lambda p, a: torch.func.functional_call(
        template, p, (a,)))(params, x)
    for i, c in enumerate(convs):
        with torch.no_grad():
            np.testing.assert_allclose(out[i].detach().numpy(),
                                       c(x[i]).numpy(), rtol=0,
                                       atol=MODULE_ATOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_cuda_farm_rollout_launches_the_kernel_once_a_step(tmp_path):
    """A DMFB farm rollout of S seeds launches ``dmfb_step`` T times at
    batch S*B, and the kernel's step at that batch equals the plain one."""
    _card()
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.ops import dmfb_step

    a = farm_args(tmp_path, device="cuda", seed=12)
    farm = seedfarm.SeedFarm(make_env_from_args(a), a, S)
    dmfb_step.launches = 0
    farm.train_cycle()
    assert dmfb_step.launches == farm.env.episode_limit
    states, noise = farm._draws(farm.env_states, farm.generators, False)
    actions = noise.rand_a[0]
    got = dmfb_step.step_batch(farm.env.params, states, actions,
                               noise.env_uniforms[0])
    want = tdmfb.step_core(farm.env.params, states, actions,
                           noise.env_uniforms[0])
    for x, y in zip(got[0], want[0]):
        assert torch.equal(x, y)
    for name in ("obs", "dones", "terminated", "constraints", "success"):
        assert torch.equal(getattr(got[1], name), getattr(want[1], name))
    assert (got[1].rewards - want[1].rewards).abs().max() <= 1e-5


@pytest.mark.cuda
def test_cuda_farm_matches_single_seeds_on_the_card(tmp_path):
    """The farm on the card against ``Trainer(seed + i)`` on the card, one
    cycle: params within the first-cycle tolerances outside float-noise
    gradients, epsilon exactly."""
    _card()
    singles = []
    for i in range(S):
        a = farm_args(tmp_path / f"s{i}", device="cuda", seed=12 + i)
        t = Trainer(make_env_from_args(a), a)
        noisy = record_noise(t)
        t.train_cycle()
        singles.append((t, noisy))
    run(farm_args(tmp_path / "farm", device="cuda", seed=12,
                  evaluate_cycle=10 ** 9), 1)
    for i, (t, noisy) in enumerate(singles):
        saved = seed_checkpoint(tmp_path / "farm", i)
        assert_params_close(saved, t, noisy, 1e-6, 1e-8, f"seed {i}")
        assert saved["epsilon"].item() == float(t.epsilon)
