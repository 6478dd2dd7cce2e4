"""The MEDA step kernel's module (``marl_dmfb_tpu_torch/ops/meda_step.py``):
the wrapper's CPU dispatch to the plain ``envs/meda.step_core``, the env
registry's binding, its input checks, the build's failure mode (no
fallback), its counters and its failed launches with the C launch stubbed,
and -- on a machine with
a card -- the CUDA kernel against the plain version over whole episodes
(80x80-10d and 30x60-4d, fov 19, every observation version, at B = 2 and
B = 4,096, on degraded and worn boards, with actions outside [0, 9) and
droplets that snap and finish), a rollout over the kernel against one over
the plain step, and a shape past the shared memory that raises.

No JAX here, so that the card's machine can run the ``cuda`` tests:
``python -m pytest --noconftest -m cuda tests/test_torch_meda_step_kernel.py``.
"""

import functools
import types

import pytest
import torch

from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.envs import meda as tmeda
from marl_dmfb_tpu_torch.ops import _build
from marl_dmfb_tpu_torch.ops import meda_step
from marl_dmfb_tpu_torch.utils import tracing

torch.set_num_threads(1)

VERSIONS = ["v0", "v0.1", "v0.2"]
TEAM_ATOL = 1e-6   # a float32 mean of up to 10 rewards, summed in another order
OUT_EXACT = ("obs", "rewards", "dones", "terminated", "constraints",
             "success")


def _inputs(version="v0.2", n=4, B=5, seed=0, width=30, length=60):
    p = tmeda.MEDAParams(width=width, length=length, n_droplets=n,
                         obs_version=version)
    g = torch.Generator().manual_seed(seed)
    s = tmeda.init(p, B, g, "cpu")
    a = torch.randint(-2, 11, (B, n), generator=g, dtype=torch.int32)
    u = torch.rand((B, n), generator=g)
    return p, s, a, u


@pytest.fixture()
def fresh_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def assert_same_step(got, want, where=""):
    """Every state field and output bitwise, but ``team_reward`` within
    ``TEAM_ATOL``; the health, degrade, start and destination tensors are
    the input's own."""
    (gs, go), (ws, wo) = got, want
    for f in tmeda.MEDAState._fields:
        x, y = getattr(gs, f), getattr(ws, f)
        assert x.dtype == y.dtype and torch.equal(x, y.to(x.device)), \
            f"{f} differs {where}: {int((x.cpu() != y.cpu()).sum())} elements"
    for f in OUT_EXACT:
        x, y = getattr(go, f), getattr(wo, f)
        assert x.dtype == y.dtype and torch.equal(x, y.to(x.device)), \
            f"{f} differs {where}: {int((x.cpu() != y.cpu()).sum())} elements"
    gap = (go.team_reward - wo.team_reward.to(go.team_reward.device)).abs()
    assert float(gap.max()) <= TEAM_ATOL, f"team_reward {where}"


@pytest.mark.parametrize("version", VERSIONS)
def test_cpu_dispatch_runs_plain_version_without_launching(version):
    p, s, a, u = _inputs(version)
    before = meda_step.launches
    got = meda_step.step_batch(p, s, a, u)
    assert meda_step.launches == before
    want = tmeda.step_core(p, s, a, u)
    assert_same_step(got, want)
    assert torch.equal(got[1].team_reward, want[1].team_reward)
    for f in ("health", "degrade", "start", "dest"):
        assert getattr(got[0], f) is getattr(s, f)


def test_registry_binds_meda_to_the_wrapper(monkeypatch):
    """``make_env("meda")``'s ``step_core`` is the wrapper and its ``step``
    draws the move-success uniforms from the generator, then calls it."""
    env = make_env("meda", width=30, length=60, n_droplets=4, version="0.2")
    assert env.step_core.func is meda_step.step_batch
    assert env.step_core.args == (env.params,)
    s = env.init(6, torch.Generator().manual_seed(3), "cpu")
    a = torch.randint(0, 9, (6, 4), generator=torch.Generator().manual_seed(4),
                      dtype=torch.int32)
    calls = []
    real = meda_step.step_batch
    monkeypatch.setattr(meda_step, "step_batch",
                        lambda *args: calls.append(args) or real(*args))
    env = make_env("meda", width=30, length=60, n_droplets=4, version="0.2")
    got = env.step(s, a, torch.Generator().manual_seed(9))
    assert len(calls) == 1
    want = tmeda.step(env.params, s, a, torch.Generator().manual_seed(9))
    assert_same_step(got, want)


@pytest.mark.parametrize("field,bad,err", [
    ("center", lambda t: t.long(), TypeError),
    ("dest", lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
    ("sq_dist", lambda t: t[:, :2], ValueError),
    ("status", lambda t: t.int(), TypeError),
    ("health", lambda t: t.double(), TypeError),
    ("usage", lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
    ("step_count", lambda t: t.float(), TypeError),
    ("fails_count", lambda t: t[:3], ValueError),
    ("actions", lambda t: t.long(), TypeError),
    ("uniforms", lambda t: t.double(), TypeError),
])
def test_wrapper_rejects_bad_inputs(field, bad, err):
    p, s, a, u = _inputs()
    if field == "actions":
        a = bad(a)
    elif field == "uniforms":
        u = bad(u)
    else:
        s = s._replace(**{field: bad(getattr(s, field))})
    with pytest.raises(err, match=field):
        meda_step.step_batch(p, s, a, u)


def test_wrapper_rejects_other_devices():
    p, s, a, u = _inputs()
    meta = tmeda.MEDAState(*(t.to("meta") for t in s))
    with pytest.raises(ValueError, match="no meda_step kernel"):
        meda_step.step_batch(p, meta, a.to("meta"), u.to("meta"))
    with pytest.raises(ValueError, match="on meta"):
        meda_step.step_batch(p, s, a.to("meta"), u)


def _stub_library(rc=0):
    calls = []

    def launch(*args):
        calls.append(args)
        return rc

    return types.SimpleNamespace(meda_step_launch=launch), calls


@pytest.mark.parametrize("version", VERSIONS)
def test_a_launch_counts_launches_and_chips(version, monkeypatch,
                                            fresh_tracer):
    """With the C launch stubbed, one call counts one launch and the batch
    in ``env.meda_step.chips``, hands the C function every pointer, the
    shape, the version and the direction's scales, and returns outputs of
    the plain version's dtypes and shapes."""
    p, s, a, u = _inputs(version, B=7)
    lib, calls = _stub_library()
    monkeypatch.setattr(meda_step, "kernel_library", lambda: lib)
    before = meda_step.launches
    tracing.enable()
    got_s, got_o = meda_step._launch(p, s, a, u, 1234)
    assert meda_step.launches == before + 1
    assert tracing.summary()["counters"] == {"env.meda_step.chips": 7}
    (args,) = calls
    assert args[:10] == tuple(t.data_ptr() for t in (
        s.center, s.sq_dist, s.dest, s.status, s.health, s.usage,
        s.step_count, s.fails_count, a, u))
    assert args[23:] == (7, 30, 60, 4, 19, p.max_step,
                         meda_step.VERSIONS[version],
                         *meda_step.direction_reciprocals(p), 1234)
    want_s, want_o = tmeda.step_core(p, s, a, u)
    for got, want in ((got_s, want_s), (got_o, want_o)):
        for x, y in zip(got, want):
            assert (x.dtype, x.shape) == (y.dtype, y.shape)
    for f in ("health", "degrade", "start", "dest"):
        assert getattr(got_s, f) is getattr(s, f)


@pytest.mark.parametrize("rc,says", [
    (1, "CUDA error 1 .*shared memory"),   # cudaErrorInvalidValue
    (74, "CUDA error 74$"),                # cudaErrorMisalignedAddress
    (700, "CUDA error 700$")])
def test_a_failed_launch_raises_and_counts_nothing(rc, says, monkeypatch,
                                                   fresh_tracer):
    """A nonzero return of the C launch raises, naming the CUDA error (an
    invalid value, which a shape past the shared memory returns, with the
    shape), and counts neither a launch nor chips."""
    p, s, a, u = _inputs(B=3)
    lib, calls = _stub_library(rc)
    monkeypatch.setattr(meda_step, "kernel_library", lambda: lib)
    before = meda_step.launches
    tracing.enable()
    with pytest.raises(RuntimeError, match=says):
        meda_step._launch(p, s, a, u, 0)
    assert len(calls) == 1
    assert meda_step.launches == before
    assert tracing.summary()["counters"] == {}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No ``nvcc``: building the kernel raises, and so does a launch,
    which never falls back to the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    if (_build.Path("/usr/local/cuda/bin/nvcc")).is_file():
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("meda_step")
    p, s, a, u = _inputs()
    before = meda_step.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        meda_step._launch(p, s, a, u, 0)
    assert meda_step.launches == before
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("version,want", [
    ("v0", (0.0, 0.0)),
    ("v0.1", (tmeda._rcp(30), tmeda._rcp(60))),
    ("v0.2", (tmeda._rcp(1.0), tmeda._rcp(2.0)))])
def test_direction_reciprocals_are_the_plain_versions(version, want):
    p = tmeda.MEDAParams(width=30, length=60, obs_version=version)
    assert meda_step.direction_reciprocals(p) == want


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_SHAPES = [(80, 80, 10), (30, 60, 4)]
CARD_BATCHES = [2, 4096]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _toward(center, dest):
    """The action that moves each droplet toward its destination: the
    table's row is the sign of the y offset, its column that of x."""
    s = torch.sign(dest - center).long()
    table = torch.tensor([[7, 0, 4], [3, 8, 1], [6, 2, 5]], dtype=torch.int32,
                         device=center.device)
    return table[s[..., 1] + 1, s[..., 0] + 1]


def _actions(state, g):
    """Half the droplets toward their goals (so that they snap and finish),
    the rest random, a tenth of those outside [0, 9)."""
    B, N = state.sq_dist.shape
    dev = state.center.device
    rand = torch.randint(0, 9, (B, N), generator=g, device=dev,
                         dtype=torch.int32)
    odd = torch.randint(-3, 14, (B, N), generator=g, device=dev,
                        dtype=torch.int32)
    r = torch.rand((B, N), generator=g, device=dev)
    return torch.where(r < 0.5, _toward(state.center, state.dest),
                       torch.where(r < 0.95, rand, odd))


def _worn_chips(p, B, g, dev):
    """Chips with degradation on: half on health in [0.5, 1), the usage
    board at integers near the 50 uses past which a reset decays it."""
    s = tmeda.init(p, B, g, dev)
    health = torch.where(torch.arange(B, device=dev)[:, None, None] % 2 == 0,
                         torch.rand(s.health.shape, generator=g, device=dev)
                         * 0.5 + 0.5, s.health)
    usage = torch.randint(40, 52, s.usage.shape, generator=g, device=dev
                          ).float()
    return s._replace(health=health, usage=usage)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", CARD_BATCHES)
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=[f"{w}x{l}-{n}d" for w, l, n in CARD_SHAPES])
def test_cuda_kernel_matches_plain_over_episodes(shape, version, batch):
    """Two whole episodes chained through the kernel and through the plain
    version on the card, from the same worn chips, actions and draws, with
    a reset between them that decays the worn cells: every state field and
    output bitwise, ``team_reward`` within ``TEAM_ATOL``."""
    dev = _card()
    W, L, N = shape
    p = tmeda.MEDAParams(width=W, length=L, n_droplets=N, fov=19,
                         obs_version=version, b_degrade=True,
                         per_degrade=1.0)
    g = torch.Generator(device=dev).manual_seed(W * 100 + N + batch)
    ks = ps = _worn_chips(p, batch, g, dev)
    before = meda_step.launches
    snapped = 0
    for episode in range(2):
        if episode:
            gen_state = g.get_state()
            ks = tmeda.reset(p, ks, g)
            g.set_state(gen_state)
            ps = tmeda.reset(p, ps, g)
        for t in range(p.episode_limit):
            a = _actions(ks, g)
            u = torch.rand((batch, N), generator=g, device=dev)
            got = meda_step.step_batch(p, ks, a, u)
            want = tmeda.step_core(p, ps, a, u)
            assert_same_step(got, want, f"at episode {episode} step {t}")
            (ks, _), (ps, _) = got, want
            snapped = max(snapped, int(ks.status.sum()))
    torch.cuda.synchronize()
    assert meda_step.launches == before + 2 * p.episode_limit
    assert snapped > 0


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v0.2", "v0.1"])
def test_cuda_rollout_over_the_kernel_matches_the_plain_step(version,
                                                             fresh_tracer):
    """A traced epsilon-greedy rollout of 80x80-10d chips over the kernel
    and one over the plain step, from the same generator state: the same
    episodes (team rewards within ``TEAM_ATOL``), one launch a step, and
    ``env.meda_step.chips`` equal to ``rollout.chip_steps``."""
    from marl_dmfb_tpu_torch.models.networks import CRNNAgent
    from marl_dmfb_tpu_torch.rollout import make_rollout

    dev = _card()
    env = make_env("meda", width=80, length=80, n_droplets=10,
                   obs_version=version)
    p, B, T = env.params, 64, env.episode_limit
    torch.manual_seed(0)
    net = CRNNAgent(n_actions=env.n_actions, obs_channels=p.n_layers,
                    fov=p.fov, conv_channels=8, rnn_hidden=16).to(dev)
    plain = env._replace(step_core=functools.partial(tmeda.step_core, p))
    g = torch.Generator(device=dev).manual_seed(11)
    start = env.init(B, g, dev)
    gen_state = g.get_state()
    res = {}
    for name, e in (("kernel", env), ("plain", plain)):
        g.set_state(gen_state)
        before = meda_step.launches
        tracing.enable()
        res[name] = make_rollout(e, net, 16)(start, g, 0.3, 0.0, 0.01)
        tracing.disable()
        counters = tracing.summary()["counters"]
        launched = meda_step.launches - before
        if name == "kernel":
            assert launched == T
            assert counters == {"env.meda_step.chips": B * T,
                                "rollout.chip_steps": B * T}
        else:
            assert launched == 0
            assert counters == {"rollout.chip_steps": B * T}
    k, q = res["kernel"], res["plain"]
    for f in ("o_ext", "u", "padded", "terminated"):
        assert torch.equal(k.episodes[f], q.episodes[f]), f
    assert float((k.episodes["r"] - q.episodes["r"]).abs().max()) <= TEAM_ATOL
    for f in ("steps", "constraints", "success"):
        assert torch.equal(getattr(k, f), getattr(q, f)), f
    for f in tmeda.MEDAState._fields:
        assert torch.equal(getattr(k.env_states, f),
                           getattr(q.env_states, f)), f


@pytest.mark.cuda
def test_cuda_shape_past_shared_memory_raises():
    """A chip whose droplets and one float32 observation row of fov 121 do
    not fit a block's shared memory: the launch returns an invalid value,
    the wrapper raises and counts no launch."""
    dev = _card()
    p = tmeda.MEDAParams(width=30, length=60, n_droplets=4, fov=121,
                         obs_version="v0.1")
    g = torch.Generator(device=dev).manual_seed(0)
    s = tmeda.init(p, 2, g, dev)
    a = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    u = torch.rand((2, 4), generator=g, device=dev)
    before = meda_step.launches
    with pytest.raises(RuntimeError, match="CUDA error 1 .*shared memory"):
        meda_step.step_batch(p, s, a, u)
    assert meda_step.launches == before
