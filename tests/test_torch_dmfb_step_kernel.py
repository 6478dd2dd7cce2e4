"""The env-step kernel's module (``marl_dmfb_tpu_torch/ops/dmfb_step.py``):
its plain version against the Pallas TPU kernel it replaces (interpret mode
on the CPU), the wrapper's CPU dispatch and input checks, the build's
failure mode, and — on a machine with a card — the CUDA kernel against the
plain version.

JAX is imported inside the tests that need it, so that the card's machine,
which has no JAX, can run the ``cuda`` test of this file:
``python -m pytest --noconftest -m cuda tests/test_torch_dmfb_step_kernel.py``.
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("width,n,blocks,B", [(10, 4, 0, 16384),
                                              (20, 4, 2, 1024),
                                              (20, 10, 0, 1024)])
def test_cuda_kernel_matches_plain(width, n, blocks, B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p = tdmfb.DMFBParams(width=width, length=width, n_droplets=n,
                         n_blocks=blocks)
    g = torch.Generator(device="cuda").manual_seed(B + n)
    s = tdmfb.init(p, B, g, "cuda")
    s = s._replace(health=torch.rand(s.health.shape, generator=g,
                                     device="cuda") * 0.5 + 0.5)
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
