"""The env-step kernel's module (``marl_dmfb_tpu_torch/ops/dmfb_step.py``):
its plain version against the Pallas TPU kernel it replaces (interpret mode
on the CPU), the wrapper's CPU dispatch and input checks, the build's
failure mode, and — on a machine with a card — the CUDA kernel against the
plain version, with its observations and in its no-observation mode (the
transition alone, which the v0.1 observation follows).

JAX is imported inside the tests that need it, so that the card's machine,
which has no JAX, can run the ``cuda`` test of this file:
``python -m pytest --noconftest -m cuda tests/test_torch_dmfb_step_kernel.py``.
"""

import types

import numpy as np
import pytest
import torch

from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from marl_dmfb_tpu_torch.ops import _build
from marl_dmfb_tpu_torch.ops import dmfb_step


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.mark.parametrize("width,n,blocks", [(10, 2, 0), (10, 4, 2),
                                            (20, 4, 0)])
def test_plain_matches_pallas_kernel(interpret_pallas, width, n, blocks):
    import marl_dmfb_tpu.ops.dmfb_step_pallas as pk
    from tests.torch_port_util import (assert_step_equal, jax_states,
                                       params_pair, to_torch_state)

    jp, tp = params_pair(width=width, length=width, n_droplets=n,
                         n_blocks=blocks, fov=9)
    B = 8
    rng = np.random.RandomState(n * 10 + blocks)
    js = jax_states(jp, B, seed=width + n, rng=rng)
    ts = to_torch_state(js)
    for it in range(4):
        acts = rng.randint(0, 5, (B, n)).astype(np.int32)
        unis = rng.rand(B, n).astype(np.float32)
        js, jo = pk.pallas_step_batch(jp, js, acts, unis)
        ts, to = dmfb_step.step_batch(tp, ts, torch.from_numpy(acts),
                                      torch.from_numpy(unis))
        assert_step_equal(js, jo, ts, to, where=f"at step {it}")


def _cpu_inputs(n=4, B=5, seed=0):
    p = tdmfb.DMFBParams(n_droplets=n, n_blocks=2)
    g = torch.Generator().manual_seed(seed)
    s = tdmfb.init(p, B, g, "cpu")
    a = torch.randint(0, 5, (B, n), generator=g, dtype=torch.int32)
    u = torch.rand((B, n), generator=g)
    return p, s, a, u


def test_cpu_dispatch_runs_plain_version_without_launching():
    p, s, a, u = _cpu_inputs()
    before = dmfb_step.launches
    s1, o1 = dmfb_step.step_batch(p, s, a, u)
    s2, o2 = tdmfb.step_core(p, s, a, u)
    assert dmfb_step.launches == before
    for x, y in zip(tuple(s1) + tuple(o1), tuple(s2) + tuple(o2)):
        assert torch.equal(x, y)


def test_cpu_transition_is_the_step_without_its_observation():
    """The no-observation mode's plain version: ``transition_batch`` on the
    CPU is ``dmfb.transition`` (``obs`` None), which is ``step_core``
    without its observation; a v0.1 step observes the new state."""
    p, s, a, u = _cpu_inputs()
    before = (dmfb_step.launches, dmfb_step.launches_no_obs)
    s1, o1 = dmfb_step.transition_batch(p, s, a, u)
    s2, o2 = tdmfb.step_core(p, s, a, u)
    assert (dmfb_step.launches, dmfb_step.launches_no_obs) == before
    assert o1.obs is None
    for x, y in zip(tuple(s1) + tuple(o1)[1:], tuple(s2) + tuple(o2)[1:]):
        assert torch.equal(x, y)
    v01 = tdmfb.DMFBParams(n_droplets=4, n_blocks=2, obs_version="v0.1")
    s3, o3 = dmfb_step.step_batch(v01, s, a, u)
    assert o3.obs.dtype == torch.float32
    assert torch.equal(o3.obs, tdmfb.observe(v01, s3))
    assert torch.equal(s3.usage, s1.usage)


@pytest.mark.parametrize("field,bad,err", [
    ("pos", lambda t: t.long(), TypeError),
    ("health", lambda t: t.double(), TypeError),
    ("block_mask", lambda t: t.to(torch.uint8), TypeError),
    ("dist", lambda t: t[:, :2], ValueError),
    ("usage", lambda t: t.transpose(1, 2), ValueError),
    ("actions", lambda t: t.long(), TypeError),
    ("uniforms", lambda t: t[:3], ValueError),
])
def test_wrapper_rejects_bad_inputs(field, bad, err):
    p, s, a, u = _cpu_inputs()
    if field == "actions":
        a = bad(a)
    elif field == "uniforms":
        u = bad(u)
    else:
        s = s._replace(**{field: bad(getattr(s, field))})
    with pytest.raises(err, match=field):
        dmfb_step.step_batch(p, s, a, u)


def test_wrapper_rejects_other_devices_and_too_many_droplets():
    p, s, a, u = _cpu_inputs()
    meta = tdmfb.DMFBState(*(t.to("meta") for t in s))
    with pytest.raises(ValueError, match="device"):
        dmfb_step.step_batch(p, meta, a.to("meta"), u.to("meta"))
    with pytest.raises(ValueError, match="on meta"):
        dmfb_step.step_batch(p, s, a.to("meta"), u)
    p17 = tdmfb.DMFBParams(width=20, length=20, n_droplets=17)
    s17 = tdmfb.init(p17, 2, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="at most 16"):
        dmfb_step.step_batch(p17, s17, torch.zeros((2, 17), dtype=torch.int32),
                             torch.zeros((2, 17)))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    if (_build.Path("/usr/local/cuda/bin/nvcc")).is_file():
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("dmfb_step")
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("kw,batch,expect", [
    # the main config at the actor batch: 748 bytes read and 1469 written
    # per chip
    (dict(), 16384, 36_323_328),
    # 20x20, 10 droplets, fov 9, by hand: read pos 80 + dist 40 + goal 80
    # + usage 1600 + block 400 + actions 40 + uniforms 40 + counters 8
    # + health 10 sectors of 32 = 2608; write pos 80 + dist 40 + usage 1600
    # + counters 8 + obs 10*245 + rewards 40 + dones 10 + team 4
    # + terminated 1 + constraints 4 + success 4 = 4241
    (dict(width=20, length=20, n_droplets=10), 1000, 1000 * (2608 + 4241)),
])
def test_min_bytes(kw, batch, expect):
    p = tdmfb.DMFBParams(**kw)
    assert dmfb_step.min_bytes(p, batch) == expect
    # without the observations: the same less N * (3 fov^2 + 2) per chip
    assert dmfb_step.min_bytes(p, batch, observe=False) == (
        expect - batch * p.n_droplets * p.obs_dim)


def _layout_spans_from_source():
    """The per-chip byte counts of ``layout`` in csrc/dmfb_step.cu, read
    from the source with C = 1."""
    import re
    src = (_build.CSRC / "dmfb_step.cu").read_text()
    body = src[src.index("inline Layout layout("):]
    body = body[:body.index("t.total")]
    return re.findall(r"take\(e, ([^)]*)\);", body)


@pytest.mark.parametrize("kw", [dict(), dict(n_droplets=3),
                                dict(width=20, length=20, n_droplets=16,
                                     fov=19)])
def test_tile_bytes_mirrors_the_kernel_layout(kw):
    p = tdmfb.DMFBParams(**kw)
    exprs = _layout_spans_from_source()
    env = dict(C=1, N=p.n_droplets, WL=p.width * p.length, od=p.obs_dim)
    assert [eval(e, {}, env) for e in exprs] == dmfb_step._span_bytes(p)
    # the no-observation mode lays the tile out with no observation row
    env["od"] = 0
    assert [eval(e, {}, env) for e in exprs] == dmfb_step._span_bytes(
        p, observe=False)
    assert dmfb_step.tile_bytes(p, 4, False) < dmfb_step.tile_bytes(p, 4)
    src = (_build.CSRC / "dmfb_step.cu").read_text()
    assert "kSmemLimit = 227 * 1024;" in src
    assert dmfb_step.SMEM_LIMIT == 227 * 1024
    assert f"kMaxDroplets = {dmfb_step.MAX_DROPLETS};" in src
    assert f"kMaxTile = {dmfb_step.MAX_TILE};" in src


@pytest.mark.parametrize("kw,batch,tile", [
    (dict(), 16384, 16),          # 1024 tiles, every span 16-byte aligned
    (dict(), 100, 4),             # the evaluation batch: 25 tiles
    (dict(), 1, 4),
    (dict(n_droplets=3), 16385, 16),   # odd obs rows: multiples of 16
    (dict(width=20, length=20, n_droplets=10), 1024, 8),
])
def test_tile_chips_is_aligned_and_fills_the_card(kw, batch, tile):
    p = tdmfb.DMFBParams(**kw)
    got = dmfb_step.tile_chips(p, batch)
    assert got == tile
    assert dmfb_step.tile_bytes(p, got) <= dmfb_step.SMEM_LIMIT
    for b in dmfb_step._span_bytes(p)[:10]:   # staged spans and obs
        assert got * b % 16 == 0


def test_tile_chips_shrinks_to_fit_shared_memory():
    small = tdmfb.DMFBParams()
    big = tdmfb.DMFBParams(width=60, length=60)
    tile = dmfb_step.tile_chips(big, 16384)
    assert tile < dmfb_step.tile_chips(small, 16384)
    assert dmfb_step.tile_bytes(big, tile) <= dmfb_step.SMEM_LIMIT
    assert dmfb_step.tile_bytes(big, tile + 4) > dmfb_step.SMEM_LIMIT
    # one chip of a board too large for shared memory is refused
    huge = tdmfb.DMFBParams(width=220, length=220, n_droplets=16)
    assert dmfb_step.tile_bytes(huge, 1) > dmfb_step.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        dmfb_step.tile_chips(huge, 8)


def _card_state(p, B, g, offset):
    """B chips on the card, as chip_smoke.py makes them (degraded health, a
    quarter of the droplets at their goals, step counts spread over the
    episode), each tensor a view that starts ``offset`` chips into its
    storage, so that offset 1 moves the spans off 16-byte boundaries."""
    n = p.n_droplets
    s = tdmfb.init(p, B + offset, g, "cuda")
    at_goal = torch.rand((B + offset, n, 1), generator=g, device="cuda") < 0.25
    goal = torch.where(at_goal, s.pos, s.goal)
    s = s._replace(
        goal=goal,
        dist=(s.pos - goal).abs().sum(-1, dtype=torch.int32),
        health=torch.rand(s.health.shape, generator=g,
                          device="cuda") * 0.5 + 0.5,
        step_count=torch.randint(0, p.max_step, (B + offset,), generator=g,
                                 device="cuda", dtype=torch.int32))
    return tdmfb.DMFBState(*(t[offset:] for t in s))


_CARD_CASES = [
    # (width, length, droplets, blocks, fov, B, offset)
    pytest.param(10, 10, 4, 0, 9, 16384, 0, id="10-4-0-16384"),
    pytest.param(20, 20, 4, 2, 9, 1024, 0, id="20-4-2-1024"),
    pytest.param(20, 20, 10, 0, 9, 1024, 0, id="20-10-0-1024"),
    # short last tiles
    *[pytest.param(10, 10, 4, 2, 9, B, 0, id=f"tail-B{B}")
      for B in (1, 3, 33, 100, 16385)],
    # droplet counts: 1, 3, 5 give spans that are not multiples of 16 bytes
    # per chip; 16 takes the 16-droplet instantiation
    *[pytest.param(10, 10, n, 1, 9, 1000, 0, id=f"N{n}") for n in (1, 3, 5)],
    pytest.param(20, 20, 16, 2, 9, 1000, 0, id="N16"),
    *[pytest.param(20, 20, 4, 2, f, 1000, 0, id=f"fov{f}")
      for f in (3, 5, 19)],
    pytest.param(12, 10, 4, 2, 5, 1000, 0, id="12x10"),
    # inputs off 16-byte boundaries: the plain-copy path on full tiles
    pytest.param(10, 10, 4, 2, 9, 1000, 1, id="unaligned"),
    # a board whose tile must shrink to fit shared memory
    pytest.param(60, 60, 4, 2, 9, 2048, 0, id="60x60"),
]


_NO_OBS_CASES = [
    # the v0.1 artifacts' boards and the batches of the main path
    pytest.param(10, 10, 2, 0, 9, 16384, 0, id="10-2-0-16384"),
    pytest.param(10, 10, 4, 0, 9, 100, 0, id="10-4-0-100"),
    pytest.param(20, 20, 3, 2, 9, 1024, 0, id="20-3-2-1024"),
    pytest.param(20, 20, 10, 0, 9, 1000, 0, id="20-10-0-1000"),
    *[pytest.param(10, 10, 3, 2, 9, B, 0, id=f"tail-B{B}") for B in (1, 5, 33)],
    pytest.param(10, 10, 4, 2, 9, 1000, 1, id="unaligned"),
    pytest.param(60, 60, 4, 2, 9, 2048, 0, id="60x60"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("width,length,n,blocks,fov,B,offset", _NO_OBS_CASES)
def test_cuda_no_observation_mode_matches_plain(width, length, n, blocks, fov,
                                                B, offset):
    """The transition alone on the card against ``dmfb.transition``; and a
    v0.1 step (the kernel's transition, then the plain v0.1 observation)
    against ``dmfb.step_core``, with its launches counted as no-observation
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p = tdmfb.DMFBParams(width=width, length=length, n_droplets=n,
                         n_blocks=blocks, fov=fov, obs_version="v0.1")
    g = torch.Generator(device="cuda").manual_seed(B + n + 1)
    s = _card_state(p, B, g, offset)
    before = (dmfb_step.launches, dmfb_step.launches_no_obs)
    for _ in range(3):
        a = torch.randint(0, 5, (B, n), generator=g, device="cuda",
                          dtype=torch.int32)
        u = torch.rand((B, n), generator=g, device="cuda")
        sk, ok = dmfb_step.transition_batch(p, s, a, u)
        sv, ov = dmfb_step.step_batch(p, s, a, u)
        sp, op = tdmfb.step_core(p, s, a, u)
        torch.cuda.synchronize()
        assert ok.obs is None
        assert torch.equal(ov.obs, op.obs)
        for got in (sk, sv):
            for f in ("pos", "dist", "usage", "step_count", "cum_constraints"):
                assert torch.equal(getattr(got, f), getattr(sp, f)), f
        for f in ("dones", "terminated", "constraints", "success"):
            assert torch.equal(getattr(ok, f), getattr(op, f)), f
        for f in ("rewards", "team_reward"):
            torch.testing.assert_close(getattr(ok, f), getattr(op, f),
                                       rtol=0, atol=1e-5)
        s = sk
    assert (dmfb_step.launches - before[0],
            dmfb_step.launches_no_obs - before[1]) == (6, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("width,length,n,blocks,fov,B,offset", _CARD_CASES)
def test_cuda_kernel_matches_plain(width, length, n, blocks, fov, B, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p = tdmfb.DMFBParams(width=width, length=length, n_droplets=n,
                         n_blocks=blocks, fov=fov)
    g = torch.Generator(device="cuda").manual_seed(B + n)
    s = _card_state(p, B, g, offset)
    for _ in range(3):
        a = torch.randint(0, 5, (B, n), generator=g, device="cuda",
                          dtype=torch.int32)
        u = torch.rand((B, n), generator=g, device="cuda")
        sk, ok = dmfb_step.step_batch(p, s, a, u)
        sp, op = tdmfb.step_core(p, s, a, u)
        torch.cuda.synchronize()
        for f in ("pos", "dist", "usage", "step_count", "cum_constraints"):
            assert torch.equal(getattr(sk, f), getattr(sp, f)), f
        for f in ("obs", "dones", "terminated", "constraints", "success"):
            assert torch.equal(getattr(ok, f), getattr(op, f)), f
        for f in ("rewards", "team_reward"):
            torch.testing.assert_close(getattr(ok, f), getattr(op, f),
                                       rtol=0, atol=1e-5)
        s = sk


def test_launch_runs_under_the_tensors_device(monkeypatch):
    """The launch sets the kernel's shared-memory attribute and reads the SM
    count of the current device and takes its stream, so the wrapper makes
    the tensors' device current around it (here with a stand-in for
    ``torch.cuda.device`` and for the launch)."""
    events = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(dmfb_step, "_check", lambda *a: None)
    monkeypatch.setattr(dmfb_step, "_launch",
                        lambda *a: events.append(("launch",)) or "stepped")
    card1 = torch.device("cuda", 1)
    state = tdmfb.DMFBState(*[torch.empty(0, device="meta")] * 10)
    state = state._replace(pos=types.SimpleNamespace(device=card1))
    assert dmfb_step.step_batch(tdmfb.DMFBParams(), state, None,
                                None) == "stepped"
    assert events == [("enter", card1), ("launch",), ("exit", card1)]


@pytest.mark.cuda
def test_cuda_launch_follows_the_tensors_device():
    """Tensors on the second card while the first is current: the kernel
    runs on the second and equals the plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    p = tdmfb.DMFBParams(n_droplets=4, n_blocks=2)
    g = torch.Generator(device="cuda").manual_seed(5)
    s = tdmfb.DMFBState(*(t.to("cuda:1") for t in _card_state(p, 1000, g, 0)))
    a = torch.randint(0, 5, (1000, 4), dtype=torch.int32, device="cuda:1")
    u = torch.rand((1000, 4), device="cuda:1")
    torch.cuda.set_device(0)
    sk, ok = dmfb_step.step_batch(p, s, a, u)
    sp, op = tdmfb.step_core(p, s, a, u)
    torch.cuda.synchronize("cuda:1")
    assert sk.pos.device == torch.device("cuda", 1)
    for f in ("pos", "dist", "usage", "step_count", "cum_constraints"):
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f
    for f in ("obs", "dones", "terminated", "constraints", "success"):
        assert torch.equal(getattr(ok, f), getattr(op, f)), f
