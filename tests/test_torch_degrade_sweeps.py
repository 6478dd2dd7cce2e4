"""The port's electrode-degradation sweeps on the card against the JAX
package's, and the sweep tool's fold.

``marl_dmfb_tpu_torch/artifacts/degrade_sweeps.json`` is written on the
card by ``tools/degrade_sweeps_torch.py``, one row for each directory of
``artifacts/DegreData/`` (the JAX package's sweeps, on the CPU, same
policies, flags and seed).  Torch generators cannot replay JAX keys, so the
two sweeps draw other tasks and moves, and the wear feedback carries the
difference on; the port is held to JAX's in distribution, with tolerances
derived from JAX's arrays alone:

* each row's epoch count is JAX's;
* each block of 5 epochs holds 5 x 20 tasks x 5 chips = 500 episodes a
  side: the two mean success rates differ by at most ``SIGMAS`` sigma of
  the difference of two independent single seeds' block means.  Where
  ``degrade_seed_spread.json`` holds the row at ``MIN_SEEDS`` or more of
  JAX's seeds, that sigma is ``sqrt(2) s_b``, with ``s_b`` the standard
  deviation of JAX's seeds' block means as the over-seeds test below takes
  it (:func:`_jax_block_sd`): a collapsing row's block mean varies from
  seed to seed with the collapse epoch, far beyond the binomial sigma of
  its 500 episodes, and that binomial sigma accepted only 11 of JAX's own
  21 seeds against JAX's committed seed on ``50by50-4d0b-eps0.3-
  b64flagship``; ``sqrt(2) s_b`` accepts every one of JAX's seeds there
  (and on ``20by20-10d0b``) and still rejects the port's curve moved a few
  epochs.  Elsewhere the sigma is binomial,
  ``sqrt(p_j (1 - p_j) / 500 + p_p (1 - p_p) / 500)``, each rate taken as
  ``(500 p + 2) / 504`` (Agresti-Coull) so that a block at 1.0 still has a
  sigma (8 episodes' worth at 4 sigma);
* where JAX's curve drops below 0.5 success, the port's first epoch below
  0.5 is within ``COLLAPSE_EPOCHS`` of JAX's (a curve that never drops
  counts as dropping at its epoch count);
* each epoch's usage sum (the wear counters of the 5 chips at the start of
  the epoch) is within ``rtol(e)`` of JAX's, relative, for e >= 1 (both
  are 0 at epoch 0).  While cells have not worn out the sum counts the
  actuations of the 100 e episodes before it, and actuations follow
  executed steps: with c the coefficient of variation of one episode's
  steps (JAX's spread of the chips' 20-task means, times sqrt(20), over its
  mean), two independent sums differ by a relative sigma of c sqrt(2 / (100
  e)), held to ``SIGMAS`` sigma.  Once cells wear out and their counters
  restart, the sum stops counting and levels off; there JAX's own sums
  range up to 5.9% over its last five epochs (``20by20-10d0b``), and
  ``USAGE_FLOOR`` bounds the difference.

One seed's collapse is one draw of a random epoch, and a collapse one
epoch apart moves a 5-epoch block mean by more than 4 binomial sigma.  So
``marl_dmfb_tpu_torch/artifacts/degrade_seed_spread.json`` holds sweeps of
the collapsing rows at several seeds a side (the port's on the card,
``degrade_sweeps_torch.py --seeds``; the JAX package's on the CPU,
``tools/degrade_seeds_jax.py``), and the port's seeds are held to JAX's,
with tolerances taken from JAX's seeds alone (written before the port's
seeds were read):

* at least ``MIN_SEEDS`` seeds a side;
* the mean over seeds of the first epoch below 0.5 differs from JAX's by at
  most ``SIGMAS`` standard errors of a difference of two means, ``s_j
  sqrt(1 / n_j + 1 / n_p)``, with ``s_j`` the standard deviation of JAX's
  seeds' epochs (at least ``EPOCH_SD_FLOOR``: epochs are integers, and
  equal epochs would give 0);
* each 5-epoch block's mean success over seeds differs from JAX's by at
  most ``SIGMAS`` standard errors of the same form, ``s_b`` the standard
  deviation of JAX's seeds' block means, at least the binomial sigma of one
  seed's block (500 episodes, the Agresti-Coull rate of JAX's mean).

The last tests run the tools on tiny sweeps on the CPU and hold their JSON
to the means of the ``.npy`` arrays that the sweeps wrote.
"""

import json
import os

import numpy as np
import pytest
import torch

from tools import degrade_sweeps_torch as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "artifacts", "DegreData")
SIGMAS = 4.0
BLOCK = 5
COLLAPSE_EPOCHS = 2
USAGE_FLOOR = 0.10
MIN_SEEDS = 8
EPOCH_SD_FLOOR = 0.5
# rows that must have been swept on the card: BASELINE.json's workload and
# the collapsing rows first, then 50by50-4d0b
REQUIRED = ("50by50-10d0b", "20by20-10d0b", "meda-80by80-10d0b",
            "50by50-4d0b")

torch.set_num_threads(1)


def _artifact() -> dict:
    with open(tool.ARTIFACT) as f:
        return json.load(f)["rows"]


def _jax(row: str) -> dict:
    return {k: np.load(os.path.join(JAX, row, f"{k}.npy"))
            for k in ("success", "steps", "usage")}


def _first_below_half(success) -> int:
    below = np.flatnonzero(np.asarray(success) < 0.5)
    return int(below[0]) if below.size else len(success)


def test_the_required_rows_ran_on_the_card():
    rows = _artifact()
    assert set(REQUIRED) <= set(rows)
    assert set(rows) <= set(os.listdir(JAX))
    for name, r in rows.items():
        assert r["device"]["smi"].startswith("NVIDIA"), name
        assert r["tasks"] == tool.TASKS and r["seed"] == tool.SEED, name
        # the DMFB sweeps stepped through the tile kernel, T = 4 W a step
        # of every episode; MEDA's step is plain PyTorch
        board = int(name.split("by")[0].split("-")[-1])
        want = (0 if name.startswith("meda-")
                else r["epochs"] * r["tasks"] * 4 * board)
        assert r["launches"] == want and r["launches_wide"] == 0, name


def _jax_block_sd(jax_seeds: dict, b: int) -> float:
    """``s_b``: the standard deviation of JAX's seeds' mean success over
    the block of epochs starting at ``b``, at least the binomial sigma of
    one seed's block (500 episodes, the Agresti-Coull rate of JAX's mean
    over the seeds)."""
    n = BLOCK * tool.TASKS * 5
    blocks = np.array([np.mean(r["success"][b:b + BLOCK])
                       for r in jax_seeds.values()])
    aj = (n * blocks.mean() + 2) / (n + 4)
    return max(blocks.std(ddof=1), np.sqrt(aj * (1 - aj) / n))


def _block_misses(row: str, success, jax_success) -> list:
    """The blocks where one seed's curve ``success`` is more than
    ``SIGMAS`` sigma from another's, ``jax_success`` (module docstring):
    ``(first epoch, difference, bound)`` each."""
    n = BLOCK * tool.TASKS * 5
    jax_seeds = _spread().get("jax", {}).get(row, {})
    misses = []
    for b in range(0, len(jax_success), BLOCK):
        pj = float(np.mean(jax_success[b:b + BLOCK]))
        pp = float(np.mean(success[b:b + BLOCK]))
        if len(jax_seeds) >= MIN_SEEDS:
            sigma = np.sqrt(2) * _jax_block_sd(jax_seeds, b)
        else:
            aj, ap = (n * pj + 2) / (n + 4), (n * pp + 2) / (n + 4)
            sigma = np.sqrt(aj * (1 - aj) / n + ap * (1 - ap) / n)
        if abs(pp - pj) > SIGMAS * sigma:
            misses.append((b, pp - pj, SIGMAS * sigma))
    return misses


@pytest.mark.parametrize("row", sorted(_artifact()))
def test_sweep_follows_jax(row):
    port, jax = _artifact()[row], _jax(row)
    epochs = jax["success"].shape[1]
    assert port["epochs"] == epochs == len(port["success"])

    jax_success = jax["success"].mean(axis=0)
    misses = _block_misses(row, port["success"], jax_success)
    assert not misses, [
        f"{row} epochs {b}-{b + BLOCK - 1}: success off JAX's by {d:.3f} "
        f"(4 sigma {bound:.3f})" for b, d, bound in misses]

    if (jax_success < 0.5).any():
        want = _first_below_half(jax_success)
        got = _first_below_half(port["success"])
        assert abs(got - want) <= COLLAPSE_EPOCHS, (row, got, want)

    steps = jax["steps"]
    c = float(np.mean(steps.std(axis=0, ddof=1) * np.sqrt(tool.TASKS)
                      / steps.mean(axis=0)))
    usage = jax["usage"].sum(axis=(0, 2, 3))
    assert usage[0] == port["usage_sum"][0] == 0
    for e in range(1, epochs):
        rtol = max(SIGMAS * c * np.sqrt(2 / (5 * tool.TASKS * e)),
                   USAGE_FLOOR)
        got = port["usage_sum"][e]
        assert abs(got - usage[e]) <= rtol * usage[e], (
            f"{row} epoch {e}: usage sum {got} against JAX's {usage[e]} "
            f"(rtol {rtol:.3f})")


def _spread() -> dict:
    with open(tool.SPREAD) as f:
        return json.load(f)


def _both_packages() -> list:
    spread = _spread()
    return sorted(set(spread.get("torch", {})) & set(spread.get("jax", {})))


@pytest.mark.parametrize("row", _both_packages())
def test_sweep_follows_jax_over_seeds(row):
    spread = _spread()
    port, jax = spread["torch"][row], spread["jax"][row]
    assert len(port) >= MIN_SEEDS and len(jax) >= MIN_SEEDS
    for r in port.values():
        assert r["device"]["smi"].startswith("NVIDIA"), row
    epochs = _jax(row)["success"].shape[1]
    assert {len(r["success"]) for r in [*port.values(), *jax.values()]} == {
        epochs}
    n_p, n_j = len(port), len(jax)
    scale = np.sqrt(1 / n_j + 1 / n_p)

    first = {k: np.array([_first_below_half(r["success"])
                          for r in side.values()], float)
             for k, side in (("port", port), ("jax", jax))}
    s_j = max(first["jax"].std(ddof=1), EPOCH_SD_FLOOR)
    diff = abs(first["port"].mean() - first["jax"].mean())
    assert diff <= SIGMAS * s_j * scale, (
        f"{row}: first epoch below 0.5 {first['port'].mean():.2f} over "
        f"{n_p} seeds against JAX's {first['jax'].mean():.2f} over {n_j} "
        f"(4 sigma {SIGMAS * s_j * scale:.2f})")

    for b in range(0, epochs, BLOCK):
        blocks = {k: np.array([np.mean(r["success"][b:b + BLOCK])
                               for r in side.values()])
                  for k, side in (("port", port), ("jax", jax))}
        pj = blocks["jax"].mean()
        s_b = _jax_block_sd(jax, b)
        diff = abs(blocks["port"].mean() - pj)
        assert diff <= SIGMAS * s_b * scale, (
            f"{row} epochs {b}-{b + BLOCK - 1}: success "
            f"{blocks['port'].mean():.3f} over {n_p} seeds against JAX's "
            f"{pj:.3f} over {n_j} (4 sigma {SIGMAS * s_b * scale:.3f})")


def _spread_rows() -> list:
    return sorted(r for r, seeds in _spread().get("jax", {}).items()
                  if len(seeds) >= MIN_SEEDS and r in _artifact())


@pytest.mark.parametrize("row", _spread_rows())
def test_single_seed_blocks_accept_every_jax_seed(row):
    """The single-seed block criterion of a row with a seed spread takes
    each of JAX's own seeds against JAX's committed seed."""
    jax_success = _jax(row)["success"].mean(axis=0)
    seeds = _spread()["jax"][row]
    assert len(seeds) >= MIN_SEEDS
    for seed, r in seeds.items():
        assert not _block_misses(row, r["success"], jax_success), (row, seed)


def _shifted(success, by: int) -> np.ndarray:
    """The curve moved ``by`` epochs later (earlier where negative), its
    ends held at the first or last epoch's rate."""
    c = np.asarray(success, float)
    if by < 0:
        return np.concatenate([c[-by:], np.repeat(c[-1], -by)])
    return np.concatenate([np.repeat(c[0], by), c[:len(c) - by]])


# The port's committed curve on the b64 row collapses one epoch before
# JAX's committed seed (44 against 45), so 5 epochs later it lies 4 after
# JAX's and its worst block reads 0.91 of the bound; 6 later reads 1.38.
SHIFTS = {"20by20-10d0b": (-3, 5),
          "50by50-4d0b-eps0.3-b64flagship": (-3, 6)}


@pytest.mark.parametrize("row,by", [(r, by) for r in _spread_rows()
                                    for by in SHIFTS[r]])
def test_single_seed_blocks_reject_a_shifted_curve(row, by):
    """The same criterion still rejects the port's committed curve moved a
    few epochs."""
    jax_success = _jax(row)["success"].mean(axis=0)
    port = _artifact()[row]["success"]
    assert not _block_misses(row, port, jax_success)
    assert _block_misses(row, _shifted(port, by), jax_success)


def test_fold_equals_the_means_of_the_arrays(tmp_path, monkeypatch):
    """A 10x10 row, 2 epochs x 2 tasks, on the CPU through the tool."""
    row = ("10by10-4d0b", "dmfb_10x10_4d_fov9_vdn",
           tool.DMFB + ["--drop_num=4", "--chip_size=10"], 2)
    monkeypatch.setattr(tool, "ROWS", tool.ROWS + [row])
    monkeypatch.setattr(tool, "TASKS", 2)
    out, arrays = tmp_path / "sweeps.json", tmp_path / "arrays"
    tool.main(["--rows", row[0], "--device=cpu",
               f"--out={out}", f"--arrays={arrays}",
               f"--work={tmp_path / 'work'}"])
    got = json.loads(out.read_text())["rows"][row[0]]
    a = {k: np.load(arrays / row[0] / f"{k}.npy")
         for k in ("success", "steps", "rewards", "health", "usage")}
    assert a["success"].shape == (5, 2) and a["usage"].shape == (5, 2, 10, 10)
    assert got["epochs"] == 2 and got["tasks"] == 2
    for k in ("success", "steps", "rewards"):
        assert got[k] == a[k].mean(axis=0).tolist(), k
    assert got["health_mean"] == a["health"].mean(axis=(0, 2, 3)).tolist()
    assert got["usage_sum"] == a["usage"].sum(axis=(0, 2, 3)).tolist()
    assert got["usage_sum"][1] > 0 == got["usage_sum"][0]
    assert got["device"]["smi"] == "cpu" and got["launches"] == 0


def test_seeds_fold_into_the_spread(tmp_path, monkeypatch):
    """The port's ``--seeds`` and the JAX package's seeds tool on a 10x10
    row, 2 epochs x 2 tasks, on the CPU: each seed's record in the spread
    artifact is the means of its own sweep, and the two packages' records
    sit side by side."""
    from tools import degrade_seeds_jax

    row = ("10by10-4d0b", "dmfb_10x10_4d_fov9_vdn",
           tool.DMFB + ["--drop_num=4", "--chip_size=10"], 2)
    for module in (tool, degrade_seeds_jax):
        monkeypatch.setattr(module, "ROWS", tool.ROWS + [row])
        monkeypatch.setattr(module, "TASKS", 2)
    spread, arrays = tmp_path / "spread.json", tmp_path / "arrays"
    tool.main(["--rows", row[0], "--seeds", "3", "4", "--device=cpu",
               f"--spread={spread}", f"--arrays={arrays}",
               f"--work={tmp_path / 'work'}"])
    got = degrade_seeds_jax.main(["--rows", row[0], "--seeds", "3",
                                  f"--spread={spread}",
                                  f"--work={tmp_path / 'jax'}"])
    assert sorted(got["torch"][row[0]]) == ["3", "4"]
    assert sorted(got["jax"][row[0]]) == ["3"]
    for seed in ("3", "4"):
        success = np.load(arrays / f"{row[0]}_s{seed}" / "success.npy")
        r = got["torch"][row[0]][seed]
        assert r["success"] == success.mean(axis=0).tolist()
        assert r["device"]["smi"] == "cpu" and r["launches"] == 0
    assert got["torch"][row[0]]["3"]["success"] != \
        got["torch"][row[0]]["4"]["success"] or \
        got["torch"][row[0]]["3"]["steps"] != \
        got["torch"][row[0]]["4"]["steps"]
    r = got["jax"][row[0]]["3"]
    assert len(r["success"]) == 2 and r["device"]["smi"] == "cpu"


def test_spread_report_reads_the_artifact():
    """``tools/degrade_spread_report.py`` on the committed spread: a line
    for each row swept by both packages, JAX's committed seed 12 passing
    the single-seed criterion against itself, and the port's card seeds
    counted."""
    from tools import degrade_spread_report as report

    lines = report.main([])
    assert [line["row"] for line in lines] == _both_packages()
    for line in lines:
        assert 12 in line["jax"]["pass_single_seed_blocks"]
        for p in ("torch", "jax"):
            assert set(line[p]["pass_single_seed_blocks"]) <= set(
                line[p]["seeds"])
            assert len(line[p]["seeds"]) >= MIN_SEEDS
