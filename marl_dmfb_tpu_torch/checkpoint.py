"""The port's checkpoints: ``torch.save`` of the tree that the JAX package's
``Trainer.save_model`` writes with Orbax (JAX ``trainer.py:317-350``).

The tree holds ``learner`` (``params``, ``target_params``, ``opt_state``,
``train_step``), ``ema`` under ``--param_ema``, ``epsilon``, ``generator``
(the training generator's state, in place of the JAX PRNG key) and
``net_config``; under ``--ckpt_replay`` also ``replay`` and
``env_states``.  Every leaf is a tensor, a number or a string, so loading
unpickles nothing else (``weights_only=True``).

A data-parallel run (``parallel/mesh.py``) writes from rank 0 alone, with
the ring and the training chips gathered to the one-device layout, and
every rank reads the file and keeps its rows (``trainer.py``), so that a
checkpoint resumes on any number of devices.

Loading is strict by name (:func:`restructure`, after JAX
``restructure_by_path``): a missing entry, an extra entry, or a leaf of
another shape or dtype kind raises ``ValueError`` naming its path.

The port also reads the JAX package's checkpoints, exported to numpy by
``tools/export_flax_npz.py`` (the one tool that imports JAX) as
``<run>_<tag>_state.npz`` at the same place: :func:`load` turns such a file
into the same tree (the JAX PRNG key has no counterpart and is not there;
see :func:`read_export`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from marl_dmfb_tpu_torch.models.convert import (from_flax_learner_state,
                                                from_flax_tree)


def model_dir(args) -> str:
    """``<data_dir>/<model_dir>/<alg>/fov<fov>``, where a run's
    checkpoints go."""
    return os.path.join(args.data_dir, args.model_dir.lstrip("./"),
                        args.alg, f"fov{args.fov}")


def model_state_path(args, tag, write: bool = False) -> str:
    """The checkpoint file for a tag, in the JAX package's scheme
    (``<data_dir>/<model_dir>/<alg>/fov<fov>/<run>_<tag>_state``): "final"
    or "3" take the current run's prefix, a tag like "0_final" names its
    run.  The port's own file adds ``.pt``, so that it never collides with
    the JAX package's Orbax directory of the same name; a JAX checkpoint
    exported to numpy adds ``.npz``.  For reading, the ``.pt`` is taken
    where there is one, else an ``.npz`` that exists; ``write`` names the
    ``.pt``."""
    name = (f"{tag}_state" if "_" in str(tag)
            else f"{args.ith_run}_{tag}_state")
    pt = os.path.join(model_dir(args), name + ".pt")
    npz = os.path.join(model_dir(args), name + ".npz")
    if write or os.path.isfile(pt) or not os.path.isfile(npz):
        return pt
    return npz


def load_model_tag(args) -> str:
    """``--load_model_name`` as a tag: "0_final" and "final" both name run
    0's final checkpoint (JAX train.py:49-53, evaluate.py:101-104)."""
    tag = args.load_model_name or "final"
    if tag.startswith(f"{args.ith_run}_"):
        tag = tag[len(f"{args.ith_run}_"):]
    return tag.rstrip("_")


def to_cpu(tree):
    """A tree with every tensor leaf detached onto the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save(path: str, tree: dict) -> None:
    """Write ``tree`` to ``path`` atomically (a reader sees the old file or
    the new one, never a part)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load(path: str) -> dict:
    """Read a checkpoint tree onto the CPU (a ``.pt`` of the port, or an
    ``.npz`` export of a JAX checkpoint, through :func:`from_export`);
    raises ``FileNotFoundError`` naming ``path`` when there is none."""
    if not os.path.isfile(path):
        npz = path[:-3] + ".npz" if path.endswith(".pt") else None
        raise FileNotFoundError(f"no checkpoint at {path}"
                                + (f" (nor at {npz})" if npz else ""))
    if path.endswith(".npz"):
        return from_export(read_export(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def read_export(path: str) -> dict:
    """An ``.npz`` of ``tools/export_flax_npz.py`` as the tree it was
    flattened from, in the JAX package's layouts (numpy leaves, nested
    dicts keyed by path component): ``ema`` and/or ``learner`` (with
    ``train_step``), ``epsilon``, and ``net_config`` as a dict."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    net_config = json.loads(str(flat.pop("net_config")))
    epsilon = flat.pop("epsilon")
    train_step = flat.pop("train_step")
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    tree.setdefault("learner", {})["train_step"] = train_step
    tree["epsilon"] = epsilon
    tree["net_config"] = net_config
    return tree


def from_export(tree: dict) -> dict:
    """A tree of :func:`read_export` as the port's checkpoint tree: the
    weights (the agent's, and a QMIX mixer's) through ``from_flax_tree``,
    a full learner state through ``from_flax_learner_state``.  A deploy
    export holds one set of weights, under ``ema`` or ``learner/params``."""
    learner = tree["learner"]
    out = {"epsilon": torch.tensor(np.float32(tree["epsilon"])),
           "net_config": dict(tree["net_config"])}
    if "target_params" in learner:   # a full export (SGD has no opt_state)
        out["learner"] = from_flax_learner_state({"opt_state": {},
                                                  **learner})
    elif "params" in learner:
        out["learner"] = {"params": from_flax_tree(learner["params"]),
                          "train_step": torch.tensor(
                              int(learner["train_step"]), dtype=torch.int32)}
    if "ema" in tree:
        out["ema"] = from_flax_tree(tree["ema"])
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _fmt(path) -> str:
    return "/".join(map(str, path)) or "<root>"


def restructure(template, data, path: str = "<checkpoint>", _at=()):
    """``data`` laid out as ``template``, checked by name: every leaf of the
    template must be at the same path in ``data``, with the same shape and
    dtype kind (floating or not), and ``data`` may hold nothing more.
    Tensor leaves move to the template leaf's device."""
    if isinstance(template, dict):
        if not isinstance(data, dict):
            raise ValueError(f"checkpoint at {path} has a leaf at "
                             f"'{_fmt(_at)}' where a tree belongs")
        extra = sorted(_fmt(_at + p) for p, _ in _leaves(
            {k: v for k, v in data.items() if k not in template}))
        if extra:
            raise ValueError(
                f"checkpoint structure mismatch at {path}: saved tree has "
                f"entries this trainer's state does not: {extra[:5]} - was "
                "it trained with different flags?")
        out = {}
        for k, t in template.items():
            if k not in data:
                raise ValueError(
                    f"checkpoint at {path} has no entry for "
                    f"'{_fmt(_at + (k,))}' - the saved layout does not "
                    "match this trainer's state")
            out[k] = restructure(t, data[k], path, _at + (k,))
        return out
    where = _fmt(_at)
    ts = tuple(getattr(template, "shape", ()))
    ls = tuple(getattr(data, "shape", ()))
    if ts != ls or isinstance(data, dict):
        raise ValueError(f"checkpoint leaf '{where}' shape mismatch at "
                         f"{path}: restored {ls} vs expected {ts}")
    if _is_float(template) != _is_float(data):
        raise ValueError(
            f"checkpoint leaf '{where}' dtype kind mismatch at {path}: "
            f"restored {getattr(data, 'dtype', type(data).__name__)} vs "
            f"expected {getattr(template, 'dtype', type(template).__name__)}")
    if isinstance(template, torch.Tensor) and isinstance(data, torch.Tensor):
        return data.to(template.device)
    return data


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return isinstance(x, float)
