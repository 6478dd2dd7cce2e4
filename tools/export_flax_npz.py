#!/usr/bin/env python3
"""Export a checkpoint of the JAX package (an Orbax directory) as a
numpy-only ``.npz`` that the PyTorch port (``marl_dmfb_tpu_torch``) reads.

    python tools/export_flax_npz.py <orbax dir> <out.npz> [--what deploy|full]

This is the one tool of the port that imports JAX: it reads the checkpoint
with ``marl_dmfb_tpu.checkpoint.restore`` and runs wherever the JAX package
is installed.  The port never imports it; it reads the file with numpy.

The file holds one array per leaf, keyed by its '/'-joined path in the
checkpoint tree (``ema/agent/conv1/w``, ``learner/opt_state/1/0/mu/...``),
in the Flax layouts, plus ``net_config`` (a JSON string) and the scalars
``epsilon`` and ``train_step``.  Leaves that are ``None`` (an empty optax
state) have no entry.

* ``--what deploy`` (the default) writes the weights that the JAX package's
  params-only load evaluates (``Trainer.load_model``, ``trainer.py:394-402``):
  the ``ema`` entry where the checkpoint has one, else ``learner/params``.
* ``--what full`` writes the learner state (``learner/params``,
  ``learner/target_params``, ``learner/opt_state``) and the ``ema`` entry,
  for a resume.  The PRNG ``key`` has no counterpart in torch, and a
  ``--ckpt_replay`` checkpoint's replay ring and env states are not
  written.

Save the file as ``<data_dir>/model/<alg>/fov<fov>/<run>_<tag>_state.npz``
and the port's ``evaluate``, ``eva_degrade`` and ``train --load_model`` find
it where the JAX package would find its Orbax directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flatten(tree, prefix: str = "") -> dict:
    """``{'/'-joined path: np.ndarray}`` of the non-None leaves of a tree of
    dicts, lists and tuples, as ``checkpoint.restore`` returns it."""
    if tree is None:
        return {}
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _net_config(tree) -> str:
    cfg = {k: (v if isinstance(v, str) else int(np.asarray(v)))
           for k, v in tree.get("net_config", {}).items()}
    return json.dumps(cfg, sort_keys=True)


def export(tree: dict, what: str = "deploy") -> dict:
    """The arrays of the ``.npz`` for a restored checkpoint tree."""
    if what not in ("deploy", "full"):
        raise ValueError(f"--what must be deploy or full, got {what!r}")
    learner = tree["learner"]
    out = {}
    if what == "deploy":
        if "ema" in tree:
            out.update(flatten(tree["ema"], "ema"))
        else:
            out.update(flatten(learner["params"], "learner/params"))
    else:
        for k in ("params", "target_params", "opt_state"):
            out.update(flatten(learner[k], f"learner/{k}"))
        if "ema" in tree:
            out.update(flatten(tree["ema"], "ema"))
    out["epsilon"] = np.asarray(tree["epsilon"], np.float32)
    out["train_step"] = np.asarray(learner["train_step"], np.int32)
    out["net_config"] = np.asarray(_net_config(tree))
    return out


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="the Orbax checkpoint directory")
    p.add_argument("out", help="the .npz to write")
    p.add_argument("--what", choices=["deploy", "full"], default="deploy")
    a = p.parse_args(argv)
    if not a.out.endswith(".npz"):
        raise SystemExit(f"{a.out}: the output must end in .npz")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from marl_dmfb_tpu import checkpoint

    arrays = export(checkpoint.restore(a.src), a.what)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    tmp = f"{a.out}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, a.out)
    n = sum(v.nbytes for v in arrays.values())
    print(f"{a.src} -> {a.out} ({a.what}: {len(arrays)} entries, "
          f"{n} bytes of arrays)")
    return a.out


if __name__ == "__main__":
    main()
