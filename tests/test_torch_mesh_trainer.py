"""Data-parallel training of the PyTorch port on the CPU, within the port:
``Trainer`` on 2 gloo ranks (``tests/torch_mesh_worker.trainer_cycles``)
against the same run on one device, checkpoints across world sizes, the
``--mesh`` CLI, the local rings, the rounding of B and the ring, and the
process-group entry points.

Small widths: DMFB 5x5 (and MEDA 15x30 under QMIX), 2 droplets, fov 5,
GRU hidden 16, 8 conv channels, 8 chips a rollout, rings of 16 episodes,
minibatches of 8, a target sync every 2 updates.  Tolerances, as ``tests/torch_learn_util``'s: the
episodes' effects (counted steps, epsilon, each rank's ring rows and
chips) exactly those of the one-device run; the loss within rtol 1e-6; the
parameters within 1e-5, except elements whose one-device gradient was
float noise (within 1e-6 of its global norm of zero) at some update, held
to ``2 * lr * updates``; and bitwise alike on both ranks after every
cycle.

No JAX here: ``python -m pytest --noconftest tests/test_torch_mesh_trainer.py``
runs on a machine without it.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from marl_dmfb_tpu_torch import replay as replay_lib
from marl_dmfb_tpu_torch import train
from marl_dmfb_tpu_torch.config import Args, make_env_from_args
from marl_dmfb_tpu_torch.parallel import distributed, mesh as mesh_lib
from marl_dmfb_tpu_torch.parallel.mesh import Mesh
from marl_dmfb_tpu_torch.trainer import Trainer
from tests import torch_mesh_worker

torch.set_num_threads(1)

N_RANKS = 2
CYCLES = 3
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5
NOISE = 1e-6


def small_args(tmp_path, name="dmfb", **kw) -> Args:
    a = Args(name=name, alg="vdn", drop_num=2, fov=5, width=5, length=5,
             evaluate_task=8, evaluate_cycle=400, n_steps=700,
             data_dir=str(tmp_path), device="cpu")
    a.load_hparams()
    a.batch_size, a.buffer_size, a.n_parallel_envs = 8, 16, 8
    a.rnn_hidden_dim, a.hyper_hidden_dim, a.target_update_cycle = 16, 8, 2
    a.anneal_steps = 500
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def run_ranks(fn, *args):
    distributed.spawn(fn, ["cpu"] * N_RANKS, "gloo", *args)


def load_ranks(out):
    return [torch.load(os.path.join(str(out), f"rank{r}.pt"),
                       weights_only=False) for r in range(N_RANKS)]


def flat(state, key="params"):
    return {(f"{part}." if part == "mixer" else "") + k: v
            for part, d in state[key].items() for k, v in d.items()}


def one_device(args, n_cycles):
    """The one-device run: a snapshot after each cycle, and the masks of
    the parameter elements whose gradient was float noise at some update."""
    trainer = Trainer(make_env_from_args(args), args)
    learner = trainer.learner
    noisy = {k: torch.zeros(v.shape, dtype=torch.bool)
             for k, v in learner.all_params.items()}
    plain = learner.loss_and_grads

    def marking(batch):
        loss, grads = plain(batch)
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values()))
        for k, g in grads.items():
            noisy[k] |= g.abs() <= NOISE * norm
        return loss, grads

    learner.loss_and_grads = marking
    snaps = []
    for _ in range(n_cycles):
        steps = trainer.train_cycle()
        snaps.append(torch_mesh_worker._snapshot(trainer, steps))
    return trainer, snaps, noisy


def assert_cycle_matches(want, got, noisy, lr, updates, where, n=N_RANKS):
    """The snapshot ``got`` of rank ``got["rank"]`` of ``n`` against the
    one-device ``want``."""
    r = got["rank"]
    assert got["steps"] == want["steps"], where
    assert got["epsilon"] == want["epsilon"], where
    assert (got["cursor"], got["size"]) == (want["cursor"], want["size"])
    C = next(iter(want["ring"].values())).shape[0]
    for k, v in want["ring"].items():
        assert torch.equal(got["ring"][k], v[r * C // n:(r + 1) * C // n]), \
            f"{where} ring {k}"
    for k, v in want["env_states"].items():
        B = v.shape[0]
        assert torch.equal(got["env_states"][k],
                           v[r * B // n:(r + 1) * B // n]), f"{where} chips {k}"
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL, err_msg=where)
    for key in ("params", "target_params"):
        mine, ref = flat(got["state"], key), flat(want["state"], key)
        for k, v in ref.items():
            diff = (mine[k] - v).abs()
            wide = diff > PARAM_ATOL
            assert not (wide & ~noisy[k]).any(), (
                f"{where} {key} {k}: {float(diff[~noisy[k]].max()):.3g}")
            assert float(diff.max()) <= max(PARAM_ATOL, 2 * lr * updates)


# MEDA 15x30, 2 droplets, fov 5, v0.2, under QMIX (its global states
# travel with the episodes)
MEDA_QMIX = dict(name="meda", width=15, length=30, version="0.2",
                 alg="qmix", qmix_hidden_dim=8)


@pytest.mark.parametrize("kw", [{}, MEDA_QMIX], ids=["dmfb", "meda_qmix"])
def test_two_rank_trainer_matches_one_device(tmp_path, kw):
    """Three cycles of ``Trainer`` on 2 ranks against one device (the
    counterpart of JAX ``test_sharded_training_trajectory_matches_
    unsharded``): the same chips, draws, ring, epsilon and update count,
    and the parameters within float noise, alike on both ranks."""
    args = small_args(tmp_path / "one", **kw)
    trainer, want, noisy = one_device(args, CYCLES)
    run_ranks(torch_mesh_worker.trainer_cycles,
              small_args(tmp_path / "mesh", **kw), CYCLES, str(tmp_path))
    got = load_ranks(tmp_path)
    updates = trainer.updates_per_rollout
    for r, rec in enumerate(got):
        assert (rec["B"], rec["ring_rows"], rec["eval_rows"]) == (8, 8, 4)
        for c, snap in enumerate(rec["cycles"]):
            assert_cycle_matches(want[c], dict(snap, rank=r), noisy,
                                 args.lr, updates * (c + 1),
                                 f"rank {r}, cycle {c}:")
    for c in range(CYCLES):
        first, second = (flat(rec["cycles"][c]["state"]) for rec in got)
        assert all(torch.equal(first[k], second[k]) for k in first), c
    m = trainer.evaluate()
    for rec in got:
        for k, v in m.items():
            assert rec["eval"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


def test_checkpoints_move_between_world_sizes(tmp_path):
    """With ``--ckpt_replay`` a 2-rank checkpoint (the ring and the chips
    gathered to the one-device layout) resumes on one device, and a
    one-device checkpoint on 2 ranks; the next cycle matches the run that
    went on."""
    one = small_args(tmp_path / "run", ckpt_replay=True)
    trainer, want, noisy = one_device(one, CYCLES)
    # one device: a checkpoint after cycle 2 (the run above went on)
    again = Trainer(make_env_from_args(one), one)
    for _ in range(2):
        again.train_cycle()
    again.save_model("single")
    run_ranks(torch_mesh_worker.trainer_cycles,
              small_args(tmp_path / "run", ckpt_replay=True), CYCLES,
              str(tmp_path), 2, "single")
    got = load_ranks(tmp_path)
    updates = trainer.updates_per_rollout * CYCLES
    for r, rec in enumerate(got):
        # the one-device checkpoint, resumed on 2 ranks, then one cycle
        assert_cycle_matches(want[2], dict(rec["resumed"], rank=r), noisy,
                             one.lr, updates, f"rank {r} resumed:")
    # the 2-rank checkpoint, resumed on one device, then one cycle
    saved = os.path.join(str(tmp_path / "run"), "model", "vdn", "fov5",
                         "0_mesh_state.pt")
    assert os.path.isfile(saved)
    single = Trainer(make_env_from_args(one), one)
    single.load_model("mesh")
    steps = single.train_cycle()
    snap = torch_mesh_worker._snapshot(single, steps)
    mesh_third = got[0]["cycles"][2]
    assert snap["steps"] == mesh_third["steps"]
    assert snap["epsilon"] == mesh_third["epsilon"]
    np.testing.assert_allclose(float(snap["loss"]), float(mesh_third["loss"]),
                               rtol=LOSS_RTOL)
    assert_cycle_matches(want[2], dict(snap, rank=0), noisy, one.lr, updates,
                         "one device resumed:", n=1)


def test_local_sampling_rounding_and_replicated_evaluation(tmp_path, capfd):
    """``--local_sampling`` on 2 ranks, with B = 7 and a ring of 15, which
    are rounded up to tile the mesh (JAX's messages), and 3 evaluation
    tasks, which do not tile it and so run whole on each rank."""
    args = small_args(tmp_path, n_parallel_envs=7, buffer_size=15,
                      evaluate_task=3, local_sampling=True)
    run_ranks(torch_mesh_worker.trainer_cycles, args, CYCLES, str(tmp_path))
    out = capfd.readouterr().out
    assert out.count("mesh: rounding rollout batch up to 8 (2 devices)") == 1
    assert out.count("mesh: rounding replay capacity up to 16 (2 devices)") \
        == 1
    got = load_ranks(tmp_path)
    for rec in got:
        assert (rec["B"], rec["ring_rows"], rec["eval_rows"]) == (8, 8, 3)
        last = rec["cycles"][-1]
        assert (last["cursor"], last["size"]) == (8, 16)
        assert all(np.isfinite(float(c["loss"])) for c in rec["cycles"])
    assert got[0]["eval"] == got[1]["eval"]
    for c in range(CYCLES):
        first, second = (flat(rec["cycles"][c]["state"]) for rec in got)
        assert all(torch.equal(first[k], second[k]) for k in first), c


def _sentinel_episodes(B, T=4, N=2, obs=6, first=0):
    """B episodes whose o_ext holds e + 1 and u holds e, e = first ..
    first + B - 1."""
    e = torch.arange(first, first + B, dtype=torch.int8)
    return {
        "o_ext": (e + 1).view(-1, 1, 1, 1).expand(B, T + 1, N, obs).clone(),
        "u": e.view(-1, 1, 1, 1).expand(B, T, N, 1).clone(),
        "r": torch.zeros((B, T, 1)),
        "padded": torch.zeros((B, T, 1), dtype=torch.bool),
        "terminated": torch.zeros((B, T, 1), dtype=torch.bool),
    }


def test_local_sampling_draws_only_written_rows():
    """After one store into a ring of twice its size, every episode that a
    rank's local sampling draws is one it stored (no zero row), from its
    own ring (the counterpart of JAX
    ``test_local_sampling_draws_only_valid_episodes``); the local store and
    sample need no collective, so each rank is played in turn."""
    n, cap, B, b = 4, 32, 16, 16
    for rank in range(n):
        mesh = Mesh(size=n, rank=rank, device=torch.device("cpu"))
        rb = replay_lib.init_replay(cap // n, 4, 2, 6)
        mine = _sentinel_episodes(B // n, first=rank * B // n)
        rb = replay_lib.store_local(rb, mine, mesh)
        assert (rb.cursor, rb.size) == (B, B)
        g = torch.Generator().manual_seed(rank)
        for _ in range(20):
            batch = replay_lib.sample_local(rb, b, mesh, g)
            ep = batch["u"][:, 0, 0, 0].long()
            assert ep.shape == (b // n,)
            assert ((rank * B // n <= ep) & (ep < (rank + 1) * B // n)).all()
            assert (batch["o_ext"] == (ep + 1).view(-1, 1, 1, 1)).all()
    with pytest.raises(ValueError, match="must tile"):
        replay_lib.sample_local(rb, 6, Mesh(4, 0, torch.device("cpu")))


def test_train_cli_mesh_end_to_end(tmp_path):
    """``train --mesh=2 --device=cpu`` starts 2 ranks, trains, and writes
    one set of curves and checkpoints (the counterpart of JAX
    ``test_trainer_cli_mesh_end_to_end``)."""
    assert train.main([
        "dmfb", "--drop_num=2", "--fov=5", "--chip_size=5",
        "--exact_steps=600", "--n_parallel_envs=8", "--mesh=2",
        "--evaluate_task=8", "--evaluate_cycle=400", "--buffer_size=32",
        "--batch_size=8", "--device=cpu", f"--data_dir={tmp_path}"]) is None
    model = tmp_path / "model" / "vdn" / "fov5"
    assert sorted(os.listdir(model)) == ["0_0_state.pt", "0_1_state.pt",
                                         "0_final_state.pt"]
    curves = tmp_path / "TrainResult" / "vdn" / "fov5" / "5by5-2d0b"
    assert len(os.listdir(curves)) == 5
    success = np.load(curves / "vdn_env(5,5,2,0,5,True)success_rate_0.npy")
    assert success.shape == (3,)


def test_mesh_flag_needs_its_devices(monkeypatch):
    """``--mesh 3`` with 2 visible cards raises before starting a rank (JAX
    ``mesh_from_flag``); in a process without a group, ``off``, ``1`` and
    ``auto`` give no mesh and a count raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--mesh=3 but only 2 devices"):
        train.main(["dmfb", "--mesh=3", "--device=cuda"])
    for flag in ("off", "1", "auto"):
        assert mesh_lib.mesh_from_flag(flag, "cpu") is None
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh_lib.mesh_from_flag("2", "cpu")


def _cards(monkeypatch, n):
    """``n`` visible cards, in a process that no launcher started;
    ``train.spawn`` and ``train.run`` record their calls instead of
    running."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MARL_DMFB_DISTRIBUTED", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    calls = {"spawn": [], "run": []}
    monkeypatch.setattr(train, "spawn", lambda fn, devices, backend, args:
                        calls["spawn"].append((list(devices), backend)))
    monkeypatch.setattr(train, "run", lambda args, mesh=None:
                        calls["run"].append(mesh))
    return calls


@pytest.mark.parametrize("cards,argv,spawned", [
    (2, ["--mesh=auto"], (["cuda:0", "cuda:1"], "nccl")),
    (4, [], ([f"cuda:{r}" for r in range(4)], "nccl")),
    (1, ["--mesh=auto"], None),
    (2, ["--mesh=off"], None),
    (2, ["--mesh=off", "--vmap_seeds=2"], None),
    (2, ["--mesh=1", "--vmap_seeds=2"], None),
    (2, ["--mesh=auto", "--device=cpu"], None),
], ids=["auto-2-cards", "default-4-cards", "auto-1-card", "off-2-cards",
        "off-farm", "one-farm", "auto-cpu"])
def test_mesh_auto_starts_a_rank_a_card(monkeypatch, cards, argv, spawned):
    """``--mesh auto`` (the default) in a process started alone is JAX's
    ``mesh_from_flag("auto")``: one rank a visible card, under NCCL, where
    more than one card is visible, as ``--mesh n`` starts them; no mesh
    with one card, on the CPU (its cores are not counted), or under
    ``--mesh=off`` or ``--mesh=1``, where the seed farm runs."""
    calls = _cards(monkeypatch, cards)
    assert train.main(["dmfb", *argv]) is None
    if spawned is None:
        assert calls == {"spawn": [], "run": [None]}
    else:
        assert calls == {"spawn": [spawned], "run": []}


def test_mesh_auto_farm_on_several_cards_exits(monkeypatch):
    """``--vmap_seeds`` under ``auto`` with several cards visible exits
    before starting a rank, naming ``--mesh=off`` (JAX train.py:39-44)."""
    calls = _cards(monkeypatch, 2)
    with pytest.raises(SystemExit, match="--mesh=off"):
        train.main(["dmfb", "--vmap_seeds=2"])
    assert calls == {"spawn": [], "run": []}
    assert mesh_lib.auto_size("cuda") == 2
    assert mesh_lib.auto_size("cpu") == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_joins_the_launchers_group(monkeypatch):
    """A launcher's variables opt in (``WORLD_SIZE`` above 1, or
    ``MARL_DMFB_DISTRIBUTED=1``); the process joins an ``env://`` group,
    gloo on the CPU, and a failure to join raises."""
    monkeypatch.delenv("MARL_DMFB_DISTRIBUTED", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not distributed.launched()
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert distributed.launched()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MARL_DMFB_DISTRIBUTED", "1")
    assert distributed.launched()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.init_distributed("cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert distributed.init_distributed("cpu") == torch.device("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        m = mesh_lib.from_group("cpu")
        assert (m.size, m.rank) == (1, 0)
        assert mesh_lib.mesh_from_flag("auto", "cpu") is None
    finally:
        dist.destroy_process_group()
    assert distributed.backend_for("cuda:1") == "nccl"
    assert distributed.rank_devices("cuda", 2) == ["cuda:0", "cuda:1"]
    assert distributed.rank_devices("cpu", 2) == ["cpu", "cpu"]
