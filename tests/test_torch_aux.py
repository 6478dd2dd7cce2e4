"""The port's aux modules against the JAX package's on the CPU, on the same
numpy-made inputs: ``td_lambda_target`` (atol 1e-6), ``store_args``, the
MEDA baseline router (``plan_path`` path for path on 50 random 30x60 tasks,
``estimated_reward`` on a healthy and a degraded board within rtol 1e-6,
``route_task`` against the root script's), the PettingZoo shim (one episode
from a JAX state carried across, step by step) and the renderer (frames
bitwise); and the port's sweep, print and router entry points."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import router_baseline as jax_router_script
from marl_dmfb_tpu.envs import baseline_router as jbr
from marl_dmfb_tpu.envs import make_env as jmake_env
from marl_dmfb_tpu.envs import meda as jmeda
from marl_dmfb_tpu.envs.pettingzoo_shim import ParallelEnvShim as JaxShim
from marl_dmfb_tpu.render import Renderer as JaxRenderer
from marl_dmfb_tpu.utils.misc import store_args as jax_store_args
from marl_dmfb_tpu.utils.returns import td_lambda_target as jax_td_lambda
from marl_dmfb_tpu_torch import multi_train, print_train, router_baseline
from marl_dmfb_tpu_torch.envs import baseline_router as tbr
from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.envs import meda as tmeda
from marl_dmfb_tpu_torch.envs.pettingzoo_shim import ParallelEnvShim
from marl_dmfb_tpu_torch.render import Renderer
from marl_dmfb_tpu_torch.utils.misc import store_args
from marl_dmfb_tpu_torch.utils.returns import td_lambda_target
from tests.torch_port_util import to_torch_state

torch.set_num_threads(1)

TD_ATOL = 1e-6
ROUTER_RTOL = 1e-6


@pytest.mark.parametrize("lengths", [(4, 7, 6), (1, 3, 7), (7, 7, 2)])
def test_td_lambda_matches_jax(lengths):
    """Episodes ending at various steps: terminated at their last step,
    padded after."""
    rs = np.random.RandomState(sum(lengths))
    b, T, n = len(lengths), 7, 3
    padded = np.zeros((b, T, 1), np.float32)
    terminated = np.zeros((b, T, 1), np.float32)
    for e, L in enumerate(lengths):
        terminated[e, L - 1:, 0] = 1
        padded[e, L:, 0] = 1
    batch = {"r": rs.randn(b, T, 1).astype(np.float32), "padded": padded,
             "terminated": terminated}
    q = rs.randn(b, T, n).astype(np.float32)
    want = np.asarray(jax_td_lambda({k: jnp.asarray(v)
                                     for k, v in batch.items()},
                                    jnp.asarray(q), 0.99, 0.8, n))
    got = td_lambda_target({k: torch.from_numpy(v) for k, v in batch.items()},
                           torch.from_numpy(q), 0.99, 0.8, n)
    assert got.shape == (b, T, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TD_ATOL)


def test_store_args_matches_jax():
    def make(decorator):
        class C:
            @decorator
            def __init__(self, a, b=2, *, c=3, d=4):
                self.seen = (a, b, c, d)
        return C

    for args, kw in (((1,), {}), ((1, 5), {"d": 7}), ((), {"a": 0, "c": 9})):
        mine, theirs = make(store_args)(*args, **kw), make(jax_store_args)(
            *args, **kw)
        assert vars(mine) == vars(theirs)
        assert {"a", "b", "c", "d"} <= set(vars(mine))


def _meda_tasks(n_tasks, drop_num, seed):
    """Random 30x60 tasks from the port's MEDA ``init``."""
    p = tmeda.MEDAParams(width=30, length=60, n_droplets=drop_num)
    states = tmeda.init(p, n_tasks, torch.Generator().manual_seed(seed),
                        "cpu")
    return p, states


def test_plan_path_matches_jax():
    _, states = _meda_tasks(50, 4, 1)
    starts, dests = states.start.numpy(), states.dest.numpy()
    for i in range(50):
        mine, theirs = [], []
        for s, d in zip(starts[i], dests[i]):
            a = tbr.plan_path(mine, tuple(s), tuple(d), 30, 60)
            b = jbr.plan_path(theirs, tuple(s), tuple(d), 30, 60)
            assert a == b, f"task {i}"
        for x, y in zip(mine, theirs):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("degraded", [False, True])
def test_estimated_reward_matches_jax(degraded):
    p, states = _meda_tasks(8, 3, 5)
    jp = jmeda.MEDAParams(width=30, length=60, n_droplets=3)
    rng = np.random.RandomState(5)
    for i in range(8):
        health = rng.rand(30, 60) * 0.4 + 0.6 if degraded else None
        jstate = types.SimpleNamespace(start=states.start[i].numpy(),
                                       dest=states.dest[i].numpy())
        want = jbr.estimated_reward(jp, jstate, m_health=health)
        got = tbr.estimated_reward(p, states, m_health=health, index=i)
        np.testing.assert_allclose(got, want, rtol=ROUTER_RTOL)
        assert np.isfinite(got[0])


def test_route_task_matches_the_root_script():
    p, states = _meda_tasks(30, 4, 9)
    limit = p.episode_limit
    for i in range(30):
        s, d = states.start[i].numpy(), states.dest[i].numpy()
        assert (router_baseline.route_task(s, d, 30, 60, limit)
                == jax_router_script.route_task(s, d, 30, 60, limit))


def test_router_baseline_cli(capsys):
    out = router_baseline.main(["20", "3", "--device=cpu"])
    assert out["metric"] == "meda_router_success_3d"
    assert 0.0 <= out["value"] <= 1.0
    assert '"metric": "meda_router_success_3d"' in capsys.readouterr().out


def _jax_state(env, seed):
    """A JAX shim's chip after ``reset`` (fresh board: every move
    succeeds)."""
    js = JaxShim(env, seed=seed)
    js.reset()
    return js


def test_shim_episode_matches_the_jax_shim():
    """One episode from a JAX chip carried across, step by step: the
    board is fresh, so every move succeeds whatever the draws."""
    kw = dict(width=8, length=8, n_droplets=3, fov=5)
    js = _jax_state(jmake_env("dmfb", **kw), 4)
    ts = ParallelEnvShim(make_env("dmfb", **kw), seed=4, device="cpu")
    ts.state = to_torch_state(jax.tree.map(lambda x: x[None], js.state))
    assert bool((ts.state.health == 1.0).all())
    rng = np.random.RandomState(1)
    for t in range(ts.env.episode_limit):
        acts = rng.randint(0, 5, size=3).tolist()
        want, got = js.step(acts), ts.step(acts)
        np.testing.assert_array_equal(np.stack(got[0]), np.stack(want[0]))
        assert got[2] == want[2] and got[3] == want[3], t
        for a in ts.agents:
            np.testing.assert_allclose(got[1][a], want[1][a], rtol=0,
                                       atol=1e-6)
        if all(want[2].values()):
            break
    np.testing.assert_array_equal(np.stack(ts.restart()),
                                  np.stack(js.restart()))


@pytest.mark.parametrize("name", ["dmfb", "meda"])
def test_frames_equal_the_jax_renderer(name):
    if name == "dmfb":
        kw = dict(width=8, length=8, n_droplets=3, fov=5, n_blocks=2)
        cls = tdmfb.DMFBState
    else:
        kw = dict(width=15, length=30, n_droplets=2, fov=9)
        cls = tmeda.MEDAState
    jenv = jmake_env(name, **kw)
    js = _jax_state(jenv, 2)
    js.step([1] * jenv.n_agents)
    # a worn board, so that the cells' shades differ
    rng = np.random.RandomState(2)
    jstate = js.state._replace(health=jnp.asarray(
        rng.rand(*js.state.health.shape), jnp.float32))
    tstate = to_torch_state(jax.tree.map(lambda x: x[None], jstate), cls=cls)
    mine = Renderer(make_env(name, **kw), u_size=12).draw(tstate)
    theirs = JaxRenderer(jenv, u_size=12).draw(jstate)
    assert mine.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("entry", ["multi_train", "print_train",
                                   "record_video", "router_baseline"])
def test_port_entry_help_renders(entry, capsys):
    mod = __import__(f"marl_dmfb_tpu_torch.{entry}", fromlist=["main"])
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    assert "--help" in capsys.readouterr().out


def _tiny_flags(tmp_path):
    return ["--chip_size=5", "--exact_steps=300", "--n_parallel_envs=2",
            "--evaluate_cycle=200", "--evaluate_task=2",
            f"--data_dir={tmp_path}", "--buffer_size=16", "--batch_size=4",
            "--device=cpu"]


def test_multi_train_sweep_and_print_train_roundtrip(tmp_path, capsys):
    """A 1x1 sweep trains with offline evaluation and writes the curves
    under run id 5 (multiTrain.py:8-23); ``print_train`` prints them back,
    and with ``--load_model`` evaluates the checkpoints again."""
    multi_train.main(["--sweep_fovs=5", "--sweep_drops=2"]
                     + _tiny_flags(tmp_path))
    assert "drop number: 2" in capsys.readouterr().out
    curves = os.path.join(str(tmp_path), "TrainResult", "vdn", "fov5",
                          "5by5-2d0b")
    success = np.load(os.path.join(curves,
                                   "vdn_env(5,5,2,0,5,True)success_rate_5.npy"))
    assert success.ndim == 1 and len(success) >= 1
    assert np.all((success >= 0) & (success <= 1))
    argv = ["dmfb", "--drop_num=2", "--fov=5", "--ith_run=5"] + \
        _tiny_flags(tmp_path)
    print_train.main(argv)
    out = capsys.readouterr().out
    assert "The successful rate are:" in out and "The runtime are:" in out
    print_train.main(argv + ["--load_model"])
    assert "The successful rate are:" in capsys.readouterr().out
