"""The port's PettingZoo-style shim (``envs/pettingzoo_shim.py``), its
renderer (``render.py``) and the rendered evaluation (``evaluate --show``,
``--show_save``, ``record_video``) on the CPU: the JAX shim tests' API,
episode and restart checks, frames, a video, and each rendered episode
against the batched greedy rollout of the same task and draws.  On a
machine with a card (``cuda``-marked): the shim's episode on the card
against the CPU's, the renderer's frame of a card state against the CPU
frame, and ``Agents.choose_action`` on the card against the CPU.  The
JAX package's shim and renderer are held against these in
``tests/test_torch_aux.py``.

No JAX here, so that the card's machine can run the ``cuda`` tests:
``python -m pytest --noconftest -m cuda tests/test_torch_shim_render.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from marl_dmfb_tpu_torch import evaluate, record_video
from marl_dmfb_tpu_torch.config import Args, get_evaluate_args
from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.envs.pettingzoo_shim import ParallelEnvShim
from marl_dmfb_tpu_torch.render import Renderer
from marl_dmfb_tpu_torch.rollout import RolloutNoise, make_rollout

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = os.path.join(ROOT, "tests", "fixtures", "torch_weights",
                      "dmfb_10x10_4d_fov9_vdn")
REWARD_ATOL = 1e-5   # a float64 sum of float32 rewards against float32's


def shim(seed=0, device="cpu", **kw):
    kw = {"width": 8, "length": 8, "n_droplets": 3, "fov": 5, **kw}
    return ParallelEnvShim(make_env("dmfb", **kw), seed=seed, device=device)


def test_reference_like_api():
    s = shim()
    assert s.agents == ["player_0", "player_1", "player_2"]
    obs = s.reset()
    assert len(obs) == 3 and obs[0].shape == (s.env.params.obs_dim,)
    obs, rew, dones, info = s.step({a: 0 for a in s.agents})
    assert set(rew) == set(s.agents) and set(dones) == set(s.agents)
    assert isinstance(info["constraints"], int)
    obs, rew, dones, info = s.step([1, 1, 1])   # lists too (dmfb.py:563)
    with pytest.raises(TypeError):
        s.step("nope")
    assert s.get_env_info()["n_agents"] == 3
    assert s.global_state().shape == (s.env.params.state_dim,)


def test_episode_runs_to_done():
    s = shim(seed=1, width=5, length=5, n_droplets=2)
    s.reset()
    for _ in range(s.env.episode_limit):
        _, _, dones, _ = s.step([0, 0])
        if all(dones.values()):
            break
    assert all(dones.values())


def test_restart_replays_the_task():
    s = shim(seed=2, n_droplets=2)
    o1 = s.reset()
    s.step([1, 2])
    o2 = s.restart()
    np.testing.assert_array_equal(np.stack(o1), np.stack(o2))


def test_seed_reseeds_the_generator():
    a, b = shim(seed=3), shim(seed=4)
    b.state = a.state
    a.seed(9)
    b.seed(9)
    np.testing.assert_array_equal(np.stack(a.reset()), np.stack(b.reset()))


def test_new_reset_starts_fresh_wear():
    s = shim(seed=5, b_degrade=True, per_degrade=1.0)
    s.reset()
    s.state = s.state._replace(health=s.state.health * 0.5)
    s.reset(new=True)
    assert bool((s.state.health == 1.0).all())


def test_the_shim_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParallelEnvShim(make_env("dmfb", width=5, length=5, n_droplets=2,
                                 fov=5))


def test_dmfb_frame():
    s = shim(n_droplets=2)
    s.reset()
    r = Renderer(s.env, u_size=10)
    f = r.draw(s.state)
    assert f.shape == (80, 80, 3) and f.dtype == np.uint8
    assert f.std() > 0
    r.close()


def test_meda_frames_and_video(tmp_path):
    pytest.importorskip("cv2")
    env = make_env("meda", width=15, length=30, n_droplets=2, fov=9)
    s = ParallelEnvShim(env, seed=0, device="cpu")
    s.reset()
    path = str(tmp_path / "v.mp4")
    r = Renderer(env, u_size=8, save_path=path)
    for _ in range(3):
        s.step([0, 1])
        f = r.draw(s.state)
        assert f.shape == (120, 240, 3) and f.std() > 0
    r.close()
    assert os.path.getsize(path) > 0


def test_video_without_opencv_names_the_package(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    env = make_env("dmfb", width=5, length=5, n_droplets=2, fov=5)
    with pytest.raises(ImportError, match="'cv2'"):
        Renderer(env, save_path="unused.mp4")


def _policy_dir(tmp_path):
    """The committed 10x10-4d export, copied where a video may be
    written."""
    shutil.copytree(POLICY, tmp_path, dirs_exist_ok=True)
    return str(tmp_path)


def test_rendered_episodes_equal_the_batched_greedy_rollout(tmp_path):
    """Each rendered episode's reward, steps, constraints and success are
    the batched greedy rollout's on the same task and move-success draws
    (captured from the rendered run)."""
    args = get_evaluate_args(["dmfb", "--drop_num=4", "--fov=9",
                              "--device=cpu", f"--data_dir={POLICY}"])
    policy = evaluate.load_policy(args)
    env = policy.env
    resets, draws = [], []

    def reset(state, g):
        state = env.reset(state, g)
        resets.append(state)
        draws.append([])
        return state

    def step(state, a, g):
        u = torch.rand(a.shape, generator=g)
        draws[-1].append(u)
        return env.step_core(state, a, u)

    policy.env = env._replace(reset=reset, step=step)
    E, T, N = 6, env.episode_limit, env.n_agents
    m = evaluate.evaluate_rendered(policy, args, episodes=E)
    per = m["per_episode"]
    uniforms = torch.zeros((T, E, N))
    for i, us in enumerate(draws):
        uniforms[:len(us), i] = torch.cat(us)
    states = type(resets[0])(*(torch.cat(f) for f in zip(*resets)))
    rollout = make_rollout(env._replace(reset=lambda s, g: s), policy.net,
                           args.rnn_hidden_dim)
    res = rollout(states, None, 0.0, 0.0, 0.0, greedy=True,
                  noise=RolloutNoise(None, None, uniforms))
    np.testing.assert_allclose(per["reward"], res.reward.numpy(), rtol=0,
                               atol=REWARD_ATOL)
    np.testing.assert_array_equal(per["steps"], res.steps.numpy())
    np.testing.assert_array_equal(per["constraints"],
                                  res.constraints.numpy())
    np.testing.assert_array_equal(per["success"], res.success.numpy())
    assert per["success"].sum() > 0
    assert m["success_rate"] == per["success"].mean()


def test_evaluate_show_save_writes_a_video(tmp_path):
    pytest.importorskip("cv2")
    data = _policy_dir(tmp_path)
    m = evaluate.main(["dmfb", "--drop_num=4", "--fov=9", "--device=cpu",
                       "--evaluate_task=2", "--show_save",
                       f"--data_dir={data}"])
    assert 0.0 <= m["success_rate"] <= 1.0
    assert len(m["per_episode"]["steps"]) == 2
    video = os.path.join(data, "video", "eval-10by10-4d0b.mp4")
    assert os.path.getsize(video) > 0


def test_record_video_writes_a_video(tmp_path):
    pytest.importorskip("cv2")
    data = _policy_dir(tmp_path)
    m = record_video.main(["dmfb", "--drop_num=4", "--fov=9", "--device=cpu",
                           "--evaluate_task=2", f"--data_dir={data}"])
    assert len(m["per_episode"]["success"]) == 2
    assert os.path.getsize(os.path.join(data, "video",
                                        "10by10-4d0b.mp4")) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_cuda_shim_episode_matches_the_cpu():
    """A shim episode on the card (the kernel at a batch of one) equals the
    same episode on the CPU, step by step.  Both start from the CPU shim's
    task on a fresh board, whose every move succeeds whatever the
    move-success draw, so the two generators' draws do not matter."""
    _card()
    from marl_dmfb_tpu_torch.ops import dmfb_step

    kw = dict(width=10, length=10, n_droplets=4, fov=9)
    cpu, card = shim(seed=7, **kw), shim(seed=7, device="cuda", **kw)
    first = cpu.reset()
    assert bool((cpu.state.health == 1.0).all())
    card.state = type(cpu.state)(*(t.cuda() for t in cpu.state))
    rng = np.random.RandomState(0)
    dmfb_step.launches = 0
    for t in range(cpu.env.episode_limit):
        acts = rng.randint(0, 5, size=4).tolist()
        want, got = cpu.step(acts), card.step(acts)
        np.testing.assert_array_equal(np.stack(got[0]), np.stack(want[0]))
        assert got[1:] == want[1:], t
        if all(want[2].values()):
            break
    assert dmfb_step.launches == t + 1
    np.testing.assert_array_equal(np.stack(card.restart()), np.stack(first))


@pytest.mark.cuda
def test_cuda_frame_equals_the_cpu_frame():
    _card()
    s = shim(seed=3)
    s.reset()
    r = Renderer(s.env, u_size=10)
    card = type(s.state)(*(t.cuda() for t in s.state))
    assert np.array_equal(r.draw(card), r.draw(s.state))


@pytest.mark.cuda
def test_cuda_choose_action_matches_the_cpu():
    _card()
    from marl_dmfb_tpu_torch.agent import Agents

    env = make_env("dmfb", width=10, length=10, n_droplets=4, fov=9)
    picks = {}
    for device in ("cpu", "cuda"):
        args = Args(name="dmfb", drop_num=4, fov=9, width=10, length=10,
                    device=device)
        args.update_env_info(env.env_info())
        agents = Agents(args)
        s = ParallelEnvShim(env, seed=0, device="cpu")
        obs = s.reset()
        last = np.zeros((4, 5))
        out = []
        for _ in range(10):
            acts = [agents.choose_action(obs[i], last[i], i, [1] * 5, 0.3)
                    for i in range(4)]
            last = np.eye(5)[acts]
            obs, _, _, _ = s.step(acts)
            out.append(acts)
        picks[device] = out
    assert picks["cpu"] == picks["cuda"]
