"""Runs one cell of ``BENCHMARK.json`` once and builds its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* a configuration: ``configs/<config>.json`` (``file`` in the entry), the
  train CLI's flags of the recipe and the values the reference needs;
* a traffic mix: ``traffic/<traffic>.json``, whose ``mode`` names the
  driver in ``modes/`` and whose other keys are that driver's parameters;
* a per-layer metric: ``metrics/<metric>.py``, a reader ``read(ctx)`` that
  returns its value or None where the run has nothing for it to read;
* a cell's limits: ``limits/<cell>.json``, set from readings
  (``calibrate.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

from benchmark.checks import load_limits, verdict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "marl_dmfb_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    chips: int
    end_to_end: list      # the end-to-end metric entries it reports
    per_layer: list       # the per-layer metric entries it reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(entry: dict, cell: str, e2e_names) -> bool:
    """Whether a metric entry is reported by ``cell``: listed in its
    ``workloads``, or, without that key, wherever what it moves is."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have "
                         f"{sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name,
                config=json.loads((root / conf["file"]).read_text()),
                traffic=load_traffic(w["traffic"]), chips=w["chips"],
                end_to_end=e2e, per_layer=per_layer)


def reference_config(config: dict, overrides: dict = None) -> dict:
    """The values the reference takes, as the configuration file states
    them (``env``, ``net``, ``learner``), with ``overrides`` on top."""
    cfg = {**config["env"], **config["net"], **config["learner"]}
    cfg.update(overrides or {})
    return cfg


# CLI flags that set a reference value, for the overrides of a rehearsal
FLAG_OF = {"width": "--width", "length": "--length", "fov": "--fov",
           "batch_size": "--batch_size", "buffer_size": "--buffer_size",
           "rollout_batch": "--n_parallel_envs"}


def program_args(config: dict, seed: int, device: str, extra=(),
                 overrides: dict = None):
    """The program's ``Args`` for the configuration's flags on one device,
    at ``seed``, exploring at the recipe's epsilon floor."""
    from marl_dmfb_tpu_torch.config import get_train_args

    argv = list(config["flags"]) + [f"--seed={seed}", f"--device={device}",
                                    "--mesh=off", *extra]
    argv += [f"{FLAG_OF[k]}={v}" for k, v in (overrides or {}).items()
             if k in FLAG_OF]
    args = get_train_args(argv, pri=False)
    args.epsilon = args.min_epsilon
    return args


def check_args(args, cfg: dict, decay_steps=None, updates=None):
    """Raise unless the program runs the configuration as its file states
    it (a run that departs from it is no sound run)."""
    pairs = {
        "width": args.width, "length": args.length,
        "n_droplets": args.drop_num, "fov": args.fov, "stall": args.stall,
        "obs_channels": args.obs_shape[0], "n_actions": args.n_actions,
        "conv_channels": args.hyper_hidden_dim,
        "rnn_hidden": args.rnn_hidden_dim, "last_action": args.last_action,
        "dtype": args.compute_dtype, "alg": args.alg, "net_kind": args.net,
        "gamma": args.gamma, "lr": args.lr,
        "grad_norm_clip": args.grad_norm_clip,
        "batch_size": args.batch_size, "buffer_size": args.buffer_size,
        "target_update_cycle": args.target_update_cycle,
        "rollout_batch": args.rollout_batch, "min_epsilon": args.min_epsilon,
        "param_ema": args.param_ema,
    }
    if decay_steps is not None:
        pairs["lr_decay_steps"] = decay_steps or 0
    if updates is not None:
        pairs["updates_per_cycle"] = updates
    wrong = {k: (v, cfg[k]) for k, v in pairs.items()
             if k in cfg and v != cfg[k]}
    if wrong:
        raise RuntimeError("the program does not run the configuration as "
                           f"stated (program, file): {wrong}")


@torch.no_grad()
def load_weights(weights: dict, modules):
    """Copy the benchmark's weights into each module, whose parameters
    must be exactly these names and shapes."""
    for m in modules:
        if m is None:
            continue
        params = dict(m.named_parameters())
        if {k: tuple(v.shape) for k, v in params.items()} != {
                k: tuple(v.shape) for k, v in weights.items()}:
            raise RuntimeError("the program's net does not have the "
                               "configuration's weights")
        for k, p in params.items():
            p.copy_(weights[k])


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def note(msg: str):
    """A line of the run's progress on standard error."""
    print(msg, file=sys.stderr, flush=True)


def read_metric(name: str, ctx: dict):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def device_line(device: str, chips: int, peak: int, trace) -> dict:
    dev = torch.device(device)
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, overrides: dict = None, calibrate: bool = False,
        plant=None) -> dict:
    """One run of ``cell``: set-up, the measured window, with ``trace``
    the spans and the profiler, then the judgement.  Returns the result
    line (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    with ``trace`` ``breakdown``, last ``checks``); with ``calibrate``
    also ``readings``, every number of the program, the control and the
    planted faults.  ``plant`` (``faults.py``) is called first in the
    process that runs the program, or in each rank process of a run over
    several cards."""
    mode = importlib.import_module(f"benchmark.modes.{cell.traffic['mode']}")
    cfg = reference_config(cell.config, overrides)
    out = mode.run(cell, cfg, seed=seed, seconds=seconds, trace=trace,
                   device=device, t_start=t_start, overrides=overrides,
                   calibrate=calibrate, plant=plant)
    ctx = out["ctx"]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    correct, rows = verdict(out["numbers"], load_limits(cell.name))
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_line(device, cell.chips, out["peak"],
                                  ctx.get("trace"))}
    if trace and ctx.get("trace") is not None:
        t = ctx["trace"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    readings = out["numbers"] | out.get("readings", {})
    if calibrate:
        line["readings"] = readings
    for k, v in readings.items():   # where a mismatch came from
        if k.startswith("mismatch."):
            note(f"{k} {v}")
    return line
