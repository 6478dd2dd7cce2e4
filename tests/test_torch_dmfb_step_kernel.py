"""The env-step kernels' module (``marl_dmfb_tpu_torch/ops/dmfb_step.py``):
its plain version against the Pallas TPU kernel it replaces (interpret mode
on the CPU), the wrapper's CPU dispatch, its choice between the tile and
the wide kernel and its input checks, the build's failure mode, and — on a
machine with a card — both CUDA kernels against the plain version, with
their observations and in their no-observation mode (the transition alone,
which the v0.1 observation follows).

JAX is imported inside the tests that need it, so that the card's machine,
which has no JAX, can run the ``cuda`` test of this file:
``python -m pytest --noconftest -m cuda tests/test_torch_dmfb_step_kernel.py``.
"""

import contextlib
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
                                            (20, 4, 0), (20, 20, 0)])
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
    """Other devices are refused; droplet counts past the tile kernel's 16
    are not (the wide kernel takes them on the card): on CPU tensors they
    run the plain version."""
    p, s, a, u = _cpu_inputs()
    meta = tdmfb.DMFBState(*(t.to("meta") for t in s))
    with pytest.raises(ValueError, match="device"):
        dmfb_step.step_batch(p, meta, a.to("meta"), u.to("meta"))
    with pytest.raises(ValueError, match="on meta"):
        dmfb_step.step_batch(p, s, a.to("meta"), u)
    p17 = tdmfb.DMFBParams(width=20, length=20, n_droplets=17)
    g = torch.Generator().manual_seed(0)
    s17 = tdmfb.init(p17, 2, g, "cpu")
    a17 = torch.randint(0, 5, (2, 17), generator=g, dtype=torch.int32)
    u17 = torch.rand((2, 17), generator=g)
    before = (dmfb_step.launches, dmfb_step.launches_wide)
    s1, o1 = dmfb_step.step_batch(p17, s17, a17, u17)
    s2, o2 = tdmfb.step_core(p17, s17, a17, u17)
    assert (dmfb_step.launches, dmfb_step.launches_wide) == before
    for x, y in zip(tuple(s1) + tuple(o1), tuple(s2) + tuple(o2)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="no dmfb_step kernel"):
        dmfb_step._launch(p, s, a, u, True, "plain")


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


@pytest.mark.parametrize("kw,batch,expect,expect_no_obs", [
    # the main config at the actor batch: 748 bytes read and 1469 written
    # per chip; without observations 4 rows of 245 fewer
    (dict(), 16384, 36_323_328, 16384 * (2217 - 4 * 245)),
    # 20x20, 10 droplets, fov 9, by hand: read pos 80 + dist 40 + goal 80
    # + usage 1600 + block 400 (fewer than 10 + 9 sectors of 32)
    # + actions 40 + uniforms 40 + counters 8 + health 10 sectors of 32
    # = 2608; write pos 80 + dist 40 + usage 1600 + counters 8
    # + obs 10*245 + rewards 40 + dones 10 + team 4 + terminated 1
    # + constraints 4 + success 4 = 4241.  Without observations the block
    # mask is read under the 10 candidate cells alone: 320 bytes, not 400
    (dict(width=20, length=20, n_droplets=10), 1000, 1000 * (2608 + 4241),
     1000 * (2608 - 80 + 4241 - 2450)),
    # 200x200, 4 droplets, fov 9: read pos 32 + dist 16 + goal 32
    # + usage 160000 + actions 16 + uniforms 16 + counters 8 + health 4
    # sectors + block 4 + 9 sectors (the candidate cells, the corner rows)
    # = 160664; write pos 32 + dist 16 + usage 160000 + counters 8
    # + obs 4*245 + rewards 16 + dones 4 + team 4 + terminated 1
    # + constraints 4 + success 4 = 161069; without observations 9
    # sectors and 980 bytes fewer
    (dict(width=200, length=200, n_droplets=4), 1, 160664 + 161069,
     160664 - 288 + 161069 - 980),
])
def test_min_bytes(kw, batch, expect, expect_no_obs):
    p = tdmfb.DMFBParams(**kw)
    assert dmfb_step.min_bytes(p, batch) == expect
    assert dmfb_step.min_bytes(p, batch, observe=False) == expect_no_obs


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
    # the dispatch's threshold is the tile kernel's bound
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
    # one chip of a board too large for shared memory: no tile fits, and
    # the board goes to the wide kernel
    huge = tdmfb.DMFBParams(width=220, length=220, n_droplets=16)
    assert dmfb_step.tile_bytes(huge, 1) > dmfb_step.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        dmfb_step.tile_chips(huge, 8)
    assert dmfb_step.kernel_for(huge) == "wide"
    assert dmfb_step.kernel_for(big) == "tile"


@pytest.mark.parametrize("width,length,n,fov,observe,kernel", [
    # the main path and the shipped configurations
    (10, 10, 4, 9, True, "tile"),
    (10, 10, 2, 9, False, "tile"),
    (50, 50, 4, 9, True, "tile"),
    (20, 20, 16, 9, True, "tile"),
    # the shapes of chip_smoke.py phase 11
    (20, 20, 20, 9, True, "wide"),
    (10, 10, 13, 9, True, "tile"),   # JAX's cap on 10x10: 13 droplets
    (50, 50, 64, 9, True, "wide"),
    (40, 40, 130, 9, True, "wide"),
    (200, 200, 4, 9, True, "wide"),
    (160, 160, 4, 9, True, "wide"),
    (160, 160, 10, 9, True, "wide"),
    (20, 20, 17, 9, False, "wide"),
    # the largest board whose one chip the tile kernel takes at 4 droplets,
    # with and without observations (which shrink the tile)
    (151, 151, 4, 9, True, "tile"),
    (152, 152, 4, 9, True, "wide"),
    (152, 152, 4, 9, False, "tile"),
])
def test_kernel_for_names_the_kernel_that_takes_the_shape(width, length, n,
                                                          fov, observe,
                                                          kernel):
    with pytest.warns(UserWarning, match="lattice") if (width, n) == (
            10, 13) else contextlib.nullcontext():
        p = tdmfb.DMFBParams(width=width, length=length, n_droplets=n,
                             fov=fov)
    assert dmfb_step.kernel_for(p, observe) == kernel
    if kernel == "tile":
        tile = dmfb_step.tile_chips(p, 16384, observe)
        assert dmfb_step.tile_bytes(p, tile, observe) <= dmfb_step.SMEM_LIMIT
    # the wide kernel's workspace stays in shared memory at these shapes
    assert dmfb_step.wide_workspace_bytes(p) <= dmfb_step.WIDE_SMEM_LIMIT


def _wide_layout_from_source(function):
    """The span expressions of ``function`` (``group_layout`` or
    ``workspace``) in csrc/dmfb_step_wide.cu, each with its kind of take
    (``take_in``: a staged input span, ``take``: the others)."""
    import re
    src = (_build.CSRC / "dmfb_step_wide.cu").read_text()
    body = src[src.index(f"inline {function}("):]
    body = body[:body.index("t.total")]
    return re.findall(r"(take(?:_in)?)\(e, (.*)\);", body)


@pytest.mark.parametrize("kw", [dict(), dict(n_droplets=3),
                                dict(width=40, length=40, n_droplets=130),
                                dict(width=200, length=200),
                                dict(width=100, length=100, fov=99)])
@pytest.mark.parametrize("chips", [1, 6, 32])
def test_wide_workspace_mirrors_the_kernel_layout(kw, chips):
    """Both layouts of the wide kernel against csrc/dmfb_step_wide.cu: the
    group layout's ``_group_spans`` and ``group_bytes`` against
    ``group_layout`` (two input buffers after 32 bytes of mbarriers, each
    input span 16 bytes wider than rounded; without observations no corner
    and no rows), the chip layout's ``_wide_spans`` against ``workspace``
    (with the rows and the corner that the launch passes, and without
    observations zeros), ``wide_rows`` against ``chunk_rows``, and the
    limits against ``kWideSmemLimit``, ``kRowBytes``, ``kThreads`` and
    ``kMaxGroup``."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p = tdmfb.DMFBParams(**kw)
    src = (_build.CSRC / "dmfb_step_wide.cu").read_text()
    spans = _wide_layout_from_source("GroupLayout group_layout")
    kinds = [kind for kind, _ in spans]
    assert kinds == ["take_in"] * 9 + ["take"] * 9
    assert "e = 32 + 2 * t.in_bytes;" in src
    od = p.obs_dim
    for observe in (True, False):
        env = dict(C=chips, N=p.n_droplets, WL=p.width * p.length,
                   M=(p.width + 2) * (p.length + 2), od=od * observe)
        got = [eval(e.replace("/", "//"), {}, env) for _, e in spans]
        inputs, work = dmfb_step._group_spans(p, chips, observe)
        assert got == inputs + work
        assert dmfb_step.group_bytes(p, chips, observe) == 32 + 2 * sum(
            -(-(b + 16) // 16) * 16 for b in got[:9]) + sum(
            -(-b // 16) * 16 for b in got[9:])
    assert dmfb_step.group_bytes(p, chips, False) < dmfb_step.group_bytes(
        p, chips)

    exprs = [e for _, e in _wide_layout_from_source("Workspace workspace")]
    rows = dmfb_step.wide_rows(p)
    assert rows == min(p.n_droplets, max(1, 8192 // od))
    assert "return min(N, max(1, kRowBytes / od));" in src
    for observe in (True, False):
        env = dict(N=p.n_droplets, WL=p.width * p.length,
                   f2=p.fov ** 2 * observe, rows=(rows * od + 16) * observe)
        assert [eval(e, {}, env) for e in exprs] == dmfb_step._wide_spans(
            p, observe)
        assert dmfb_step.wide_workspace_bytes(p, observe) == sum(
            -(-eval(e, {}, env) // 16) * 16 for e in exprs)
    assert "kWideSmemLimit = 227 * 1024 - 1024;" in src
    assert dmfb_step.WIDE_SMEM_LIMIT == 227 * 1024 - 1024
    assert "kRowBytes = 8192;" in src and dmfb_step.WIDE_ROW_BYTES == 8192
    assert "kThreads = 128;" in src and dmfb_step.GROUP_THREADS == 128
    assert f"kMaxGroup = {dmfb_step.MAX_GROUP};" in src
    assert "kSmemLimit = 227 * 1024;" in src


def _wide(width, n, fov=9, length=None):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the lattice fallback's warning
        return tdmfb.DMFBParams(width=width, length=length or width,
                                n_droplets=n, fov=fov)


@pytest.mark.parametrize("width,n,batch,observe,chips", [
    # the timed shapes: a (chip, droplet) pair a thread, two blocks an SM
    (20, 20, 16384, True, 6), (20, 20, 16384, False, 6),
    (10, 13, 16384, True, 9), (50, 64, 4096, True, 2),
    (50, 64, 4096, False, 2),
    # droplet counts at the cuts of 128 pairs: 7, 4, 3, 2 and 1 chips
    (20, 17, 16384, True, 7), (20, 32, 16384, True, 4),
    (20, 33, 16384, True, 3), (30, 64, 16384, True, 2),
    (30, 65, 16384, True, 1),
    # small batches: enough groups for two an SM, else one chip a group
    (20, 20, 1024, True, 3), (20, 20, 1001, True, 3),
    (20, 20, 100, True, 1), (20, 20, 1, True, 1),
    # the main config's board takes the most chips that fill the card
    (10, 4, 16384, True, 32), (10, 4, 4096, True, 15),
    # the layout cut at 4 droplets: 97x97 is the largest board on which a
    # group of one chip leaves room for a second block on the SM
    (97, 4, 1024, True, 1), (98, 4, 1024, True, 0),
    (97, 4, 1024, False, 1), (98, 4, 1024, False, 0),
    (138, 4, 1024, True, 0),
    # boards whose usage board is the cost: one block a chip
    (160, 4, 1024, True, 0), (200, 4, 1024, True, 0),
    (160, 10, 64, True, 0),
])
def test_wide_group_chips_sizes_the_group(width, n, batch, observe, chips):
    p = _wide(width, n)
    got = dmfb_step.wide_group_chips(p, batch, observe)
    assert got == chips
    blocks = dmfb_step._blocks_per_sm(dmfb_step.group_bytes(p, max(chips, 1),
                                                             observe))
    if chips:
        assert chips <= dmfb_step.MAX_GROUP and chips <= batch
        assert chips * n <= dmfb_step.GROUP_THREADS or chips == 1
        assert blocks >= 2
    else:
        assert blocks < 2


@pytest.mark.parametrize("width,n,batch,observe,group,slots", [
    (20, 20, 1024, True, 3, 0),
    (20, 20, 1001, False, 3, 0),
    (50, 64, 256, True, 1, 0),
    (200, 4, 8, True, 0, 0),
    # a workspace past shared memory: one slice of scratch a block of the
    # grid, at most 16 blocks an SM (2 SMs here)
    (500, 4, 4, True, 0, 4),
    (200, 4489, 40, False, 0, 32),
])
def test_wide_launch_passes_the_layout_and_its_scratch(
        monkeypatch, width, n, batch, observe, group, slots):
    """The wrapper's host-side sizing of a wide launch, with a stand-in for
    the library and the card: the group it passes (0: the chip layout),
    the scratch buffer (only for a chip-layout workspace past
    ``WIDE_SMEM_LIMIT``, ``slots`` workspaces of ``wide_workspace_bytes``)
    and the launch count."""
    p = _wide(width, n)
    calls = []

    class Lib:
        def dmfb_step_wide_launch(self, *args):
            calls.append(args)
            return 0

    allocated = []
    real_empty = torch.empty

    def empty(shape, **kw):
        allocated.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(dmfb_step, "wide_library", Lib)
    monkeypatch.setattr(dmfb_step.torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=2))
    monkeypatch.setattr(dmfb_step, "launches_wide", 0)
    chips = (batch, width, width)
    state = tdmfb.DMFBState(   # the shapes alone matter here
        pos=torch.zeros((batch, n, 2), dtype=torch.int32),
        start=torch.zeros((batch, n, 2), dtype=torch.int32),
        goal=torch.zeros((batch, n, 2), dtype=torch.int32),
        dist=torch.zeros((batch, n), dtype=torch.int32),
        health=torch.zeros(chips), usage=torch.zeros(chips),
        block_mask=torch.zeros(chips, dtype=torch.bool),
        degrade=torch.zeros(chips),
        step_count=torch.zeros(batch, dtype=torch.int32),
        cum_constraints=torch.zeros(batch, dtype=torch.int32))
    actions = torch.zeros((batch, n), dtype=torch.int32)
    uniforms = torch.zeros((batch, n))
    dmfb_step._launch(p, state, actions, uniforms, observe, "wide")
    (args,) = calls
    scratch, got_slots, sizes = args[22], args[23], args[24:31]
    assert tuple(sizes) == (batch, width, width, n, 9, int(p.stall),
                            p.max_step)
    assert (args[31], args[32], args[35]) == (group, int(observe), 7)
    assert dmfb_step.launches_wide == 1
    assert got_slots == slots
    assert (scratch != 0) == bool(slots)
    if slots:
        assert (slots, dmfb_step.wide_workspace_bytes(p, observe)) in \
            allocated


def test_wide_workspace_goes_to_global_memory_beyond_shared_memory():
    """A board of 500x500 (250,000 bytes of count map) and 200x200 with
    JAX's most droplets there (4,489: 40,000 bytes of count map and 57 a
    droplet, before the observation rows) take a scratch buffer."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        big = tdmfb.DMFBParams(width=500, length=500, n_droplets=4)
        crowded = tdmfb.DMFBParams(width=200, length=200, n_droplets=4489)
    assert dmfb_step.wide_workspace_bytes(crowded, False) == 278_000
    for p in (big, crowded):
        assert dmfb_step.kernel_for(p) == "wide"
        assert dmfb_step.wide_workspace_bytes(p) > dmfb_step.WIDE_SMEM_LIMIT


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


_WIDE_CASES = [
    # (width, length, droplets, blocks, fov, B, offset, layout): "auto" as
    # the wrapper chooses, "chip" one block a chip (a group of one chip
    # made not to fit), "scratch" that with the workspace in global memory
    pytest.param(20, 20, 20, 0, 9, 512, 0, "auto", id="20-20-512"),
    pytest.param(20, 20, 20, 2, 9, 100, 1, "auto", id="20-20-blocks-unaligned"),
    pytest.param(20, 20, 17, 2, 3, 33, 0, "auto", id="20-17-fov3"),
    pytest.param(20, 20, 24, 0, 19, 64, 0, "auto", id="20-24-fov19"),
    pytest.param(10, 10, 13, 0, 9, 256, 0, "auto", id="10-13-cap"),
    pytest.param(40, 40, 130, 0, 9, 32, 0, "auto", id="40-130-ids"),
    pytest.param(200, 200, 4, 2, 9, 16, 0, "auto", id="200-4"),
    pytest.param(160, 160, 10, 0, 9, 16, 1, "auto", id="160-10-unaligned"),
    pytest.param(64, 64, 20, 2, 9, 64, 1, "auto", id="64-20-one-warp"),
    pytest.param(65, 64, 20, 2, 9, 64, 0, "auto", id="65x64-20-four-warps"),
    pytest.param(12, 10, 4, 2, 5, 1, 0, "auto", id="12x10-B1"),
    # the workspace in the global scratch buffer
    pytest.param(20, 20, 20, 2, 9, 64, 0, "scratch", id="20-20-scratch"),
    pytest.param(500, 500, 4, 0, 9, 4, 0, "auto", id="500-4-scratch"),
    # the group layout's edges: droplet counts at the cuts of its 128
    # (chip, droplet) pairs (7, 4, 3, 2, 1 chips a group), a last group
    # that is short, views at offset 1, odd boards and counts
    *[pytest.param(w, w, n, 2, 9, 1001, off, "auto", id=f"N{n}-B1001")
      for w, n, off in ((20, 17, 1), (20, 32, 0), (20, 33, 1), (30, 64, 0),
                        (30, 65, 1))],
    pytest.param(20, 20, 20, 2, 9, 16387, 1, "auto", id="20-20-ragged"),
    pytest.param(11, 13, 13, 2, 5, 777, 1, "auto", id="11x13-13-odd"),
    # a board on each side of the layout cut at 4 droplets
    pytest.param(97, 97, 4, 2, 9, 37, 1, "auto", id="97-4-group"),
    pytest.param(98, 98, 4, 2, 9, 37, 1, "auto", id="98-4-chip"),
    # the chip layout on a small board
    pytest.param(20, 20, 20, 2, 9, 257, 1, "chip", id="20-20-chip"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("width,length,n,blocks,fov,B,offset,layout",
                         _WIDE_CASES)
def test_wide_kernel_matches_plain(monkeypatch, width, length, n, blocks, fov,
                                   B, offset, layout):
    """The wide kernel (forced here; ``kernel_for`` names it where the
    tile kernel cannot take the shape) against the plain version over 3
    chained steps, with observations and without."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import warnings
    if layout != "auto":
        monkeypatch.setattr(dmfb_step, "wide_group_chips",
                            lambda params, batch, observe=True: 0)
    if layout == "scratch":
        monkeypatch.setattr(dmfb_step, "WIDE_SMEM_LIMIT", 0)
    monkeypatch.setattr(dmfb_step, "kernel_for",
                        lambda params, observe=True: "wide")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the lattice fallback's warning
        p = tdmfb.DMFBParams(width=width, length=length, n_droplets=n,
                             n_blocks=blocks, fov=fov)
    g = torch.Generator(device="cuda").manual_seed(B + n + width)
    before = (dmfb_step.launches, dmfb_step.launches_wide)
    for observe in (True, False):
        s = _card_state(p, B, g, offset)
        kernel = dmfb_step.step_batch if observe else dmfb_step.transition_batch
        plain = tdmfb.step_core if observe else tdmfb.transition
        for _ in range(3):
            a = torch.randint(0, 5, (B, n), generator=g, device="cuda",
                              dtype=torch.int32)
            u = torch.rand((B, n), generator=g, device="cuda")
            sk, ok = kernel(p, s, a, u)
            sp, op = plain(p, s, a, u)
            torch.cuda.synchronize()
            for f in ("pos", "dist", "usage", "step_count",
                      "cum_constraints"):
                assert torch.equal(getattr(sk, f), getattr(sp, f)), f
            for f in ("obs",) * observe + ("dones", "terminated",
                                           "constraints", "success"):
                assert torch.equal(getattr(ok, f), getattr(op, f)), f
            assert ok.obs is None or observe
            for f in ("rewards", "team_reward"):
                torch.testing.assert_close(getattr(ok, f), getattr(op, f),
                                           rtol=0, atol=1e-5)
            s = sk
    assert (dmfb_step.launches - before[0],
            dmfb_step.launches_wide - before[1]) == (0, 6)


@pytest.mark.cuda
def test_wide_kernel_equals_the_tile_kernel_on_the_main_board(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p = tdmfb.DMFBParams(n_droplets=4, n_blocks=2)
    g = torch.Generator(device="cuda").manual_seed(11)
    s = _card_state(p, 4096, g, 0)
    for _ in range(3):
        a = torch.randint(0, 5, (4096, 4), generator=g, device="cuda",
                          dtype=torch.int32)
        u = torch.rand((4096, 4), generator=g, device="cuda")
        with monkeypatch.context() as m:
            m.setattr(dmfb_step, "kernel_for",
                      lambda params, observe=True: "wide")
            sw, ow = dmfb_step.step_batch(p, s, a, u)
        st, ot = dmfb_step.step_batch(p, s, a, u)
        torch.cuda.synchronize()
        for f in ("pos", "dist", "usage", "step_count", "cum_constraints"):
            assert torch.equal(getattr(sw, f), getattr(st, f)), f
        for f in ("obs", "dones", "terminated", "constraints", "success",
                  "rewards"):
            assert torch.equal(getattr(ow, f), getattr(ot, f)), f
        torch.testing.assert_close(ow.team_reward, ot.team_reward, rtol=0,
                                   atol=1e-5)
        s = sw


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
