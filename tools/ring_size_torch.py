#!/usr/bin/env python3
"""The replay ring of a training configuration, and what carrying it across
a resume costs: its bytes by field (what ``--ckpt_replay`` adds to a
checkpoint), and the gzip size of a ring holding a trained policy's
episodes (what a packed run directory would carry).

    python3 tools/ring_size_torch.py --policy \\
        tests/fixtures/torch_weights/dmfb_20x20_4d_fov9_qmix_torch \\
        --episodes 640 -- dmfb --drop_num=4 --fov=9 --chip_size=20 \\
        --alg=qmix --n_parallel_envs=64

On the CPU.  The flags after ``--`` are the train CLI's; the ring has its
``--buffer_size`` episodes (shapes only: it is not allocated).  Then
``--episodes`` rows are filled with epsilon-greedy rollouts (epsilon the
training's floor) of the policy saved under ``--policy`` (``evaluate``'s
data directory) at the CLI's chips a rollout, written with ``torch.save``
and gzipped (level 6, as ``tar czf``); the full ring's packed size is that
per episode times the capacity.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--policy", required=True)
    p.add_argument("--episodes", type=int, default=640)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("train", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    a.train = [x for x in a.train if x != "--"]
    return a


def main(argv=None) -> dict:
    from marl_dmfb_tpu_torch.config import (get_evaluate_args,
                                            get_train_args,
                                            make_env_from_args)
    from marl_dmfb_tpu_torch.evaluate import load_policy
    from marl_dmfb_tpu_torch.replay import init_replay, store
    from marl_dmfb_tpu_torch.rollout import make_rollout

    a = parse(argv)
    args = get_train_args(a.train + ["--device=cpu", "--mesh=off"],
                          pri=False)
    env = make_env_from_args(args)
    args.update_env_info(env.env_info())
    qmix = args.alg == "qmix"
    shape = dict(episode_limit=args.episode_limit, n_agents=args.n_agents,
                 obs_dim=args.obs_shape[-1], obs_dtype=env.params.obs_dtype,
                 state_dim=args.state_shape if qmix else None)
    full = init_replay(args.buffer_size, device="meta", **shape)
    fields = {k: v.nbytes for k, v in full.data.items()}

    # the policy's episodes in a ring of a.episodes rows
    policy = load_policy(get_evaluate_args(
        a.train + ["--device=cpu", f"--data_dir={a.policy}",
                   "--evaluate_task=1"]))
    rollout = make_rollout(env, policy.net, args.rnn_hidden_dim,
                           with_state=qmix)
    ring = init_replay(a.episodes, **shape)
    g = torch.Generator().manual_seed(a.seed)
    chips = env.init(args.rollout_batch, g, "cpu")
    steps = collected = 0
    while ring.size < a.episodes:
        res = rollout(chips, g, args.min_epsilon, 0.0, args.min_epsilon)
        chips = res.env_states
        ring = store(ring, res.episodes)
        steps += int((~res.episodes["padded"]).sum())
        collected += args.rollout_batch
    buf = io.BytesIO()
    torch.save(ring.data, buf)
    raw = buf.getbuffer().nbytes
    packed = len(gzip.compress(buf.getvalue(), compresslevel=6))
    per = packed / a.episodes
    line = {
        "config": " ".join(a.train), "capacity": args.buffer_size,
        "bytes_by_field": fields, "bytes": sum(fields.values()),
        "mib": sum(fields.values()) / 2 ** 20,
        "filled_episodes": a.episodes,
        "mean_episode_steps": steps / collected,
        "filled_saved_bytes": raw, "filled_gzip_bytes": packed,
        "full_ring_gzip_mib": per * args.buffer_size / 2 ** 20,
        "policy": os.path.relpath(os.path.abspath(a.policy), ROOT),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
