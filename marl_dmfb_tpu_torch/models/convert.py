"""Carry the JAX package's weights across to the port.

:func:`from_flax_params` takes the Flax parameter tree of an agent net as
plain numpy arrays (as ``marl_dmfb_tpu.checkpoint.restore`` returns them, or
``jax.tree.map(np.asarray, params)``), so the port never imports flax;
:func:`from_flax_mixer` takes a QMIX mixer's, and :func:`from_flax_tree`
a ``{"agent": ..., "mixer": ...}`` params tree.  Layouts: a conv kernel is
HWIO in Flax and OIHW in torch; a dense kernel is (in, out) in Flax and
(out, in) in torch; the GRU's ``wi/wh/bi/bh`` are torch's
``weight_ih/weight_hh/bias_ih/bias_hh`` with the kernels transposed (the
gate order r, z, n is the same); the mixer's layers keep their names.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    """A float32 copy of a float weight; another dtype kind raises, so that a
    strict load sees no silent cast."""
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        raise ValueError(f"a weight of dtype {x.dtype}: expected floating")
    return torch.tensor(x.astype(np.float32))   # a contiguous copy


def _dense(prefix: str, p: Mapping) -> dict:
    return {f"{prefix}.weight": _t(np.asarray(p["w"]).T),
            f"{prefix}.bias": _t(p["b"])}


def from_flax_params(tree: Mapping) -> dict:
    """Flax agent params (``{"conv1": {"w", "b"}, ..., "gru": {...}}``, or
    the same under a top-level ``"params"``) -> a torch ``state_dict`` for
    :class:`CRNNAgent` or :class:`RNNAgent`."""
    if "params" in tree:
        tree = tree["params"]
    sd = {}
    convs = sorted((k for k in tree if k.startswith("conv")),
                   key=lambda k: int(k[4:]))
    for i, name in enumerate(convs):
        sd[f"convs.{i}.weight"] = _t(
            np.asarray(tree[name]["w"]).transpose(3, 2, 0, 1))
        sd[f"convs.{i}.bias"] = _t(tree[name]["b"])
    for name in ("mlp1", "fc1", "fc2"):
        if name in tree:
            sd.update(_dense(name, tree[name]))
    g = tree["gru"]
    sd["gru.weight_ih"] = _t(np.asarray(g["wi"]).T)
    sd["gru.weight_hh"] = _t(np.asarray(g["wh"]).T)
    sd["gru.bias_ih"] = _t(g["bi"])
    sd["gru.bias_hh"] = _t(g["bh"])
    return sd


def from_flax_mixer(tree: Mapping) -> dict:
    """Flax QMIX mixer params (dense layers by name, ``{"hyper_w1_1":
    {"w", "b"}, ...}``) -> a torch ``state_dict`` for :class:`QMixer`."""
    sd = {}
    for name in sorted(tree):
        sd.update(_dense(name, tree[name]))
    return sd


def from_flax_tree(tree: Mapping) -> dict:
    """A params tree (``{"agent": ..., "mixer": ...}``, the mixer only under
    QMIX) -> the same tree of torch ``state_dict``s."""
    out = {"agent": from_flax_params(tree["agent"])}
    if tree.get("mixer") is not None:
        out["mixer"] = from_flax_mixer(tree["mixer"])
    return out


def _optax_states(node):
    """The optax states inside an optax ``opt_state``, in order: the
    NamedTuples themselves, or the name-keyed dicts that a restored Orbax
    checkpoint holds in their place."""
    if hasattr(node, "_asdict"):
        fields = node._asdict()
        if fields:
            yield fields
        return
    if isinstance(node, dict):
        if {"count", "mu", "nu"} & set(node):
            yield node
            return
        node = list(node.values())
    if isinstance(node, (list, tuple)):
        for child in node:
            yield from _optax_states(child)


def from_flax_learner_state(tree: Mapping) -> dict:
    """A JAX ``LearnerState`` (``params``, ``target_params``, ``opt_state``,
    ``train_step``; a NamedTuple or its ``_asdict()``, leaves as numpy
    arrays) -> the tree that ``QLearner.load_state`` takes.

    Adam's ``count``/``mu``/``nu`` become ``count``/``mu``/``nu``,
    rmsprop's ``nu`` becomes ``nu``, and a learning-rate schedule's
    ``count`` becomes ``schedule_count``; the moments take the parameters'
    layouts, a QMIX mixer's included."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    count = lambda x: torch.tensor(int(np.asarray(x)), dtype=torch.int32)
    opt = {}
    for fields in _optax_states(tree["opt_state"]):
        if "mu" in fields:
            opt.update(count=count(fields["count"]),
                       mu=from_flax_tree(fields["mu"]),
                       nu=from_flax_tree(fields["nu"]))
        elif "nu" in fields:
            opt["nu"] = from_flax_tree(fields["nu"])
        elif "count" in fields:
            opt["schedule_count"] = count(fields["count"])
    return {
        "params": from_flax_tree(tree["params"]),
        "target_params": from_flax_tree(tree["target_params"]),
        "opt_state": opt,
        "train_step": count(tree["train_step"]),
    }
