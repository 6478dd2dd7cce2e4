"""The yardstick's arithmetic: the agent net's FLOPs, the DMFB step's least
bytes, and the peaks they are held against.

FLOPs count the multiply-adds of the convs and the matmuls only, 2 FLOPs
each, of one forward of one agent at one step; an update counts 4 such
forwards a sample (the eval stream's forward and backward, about 3, and
the target stream's forward), over batch x agents x T samples.
"""

from __future__ import annotations

from benchmark.reference.net import MLP_WIDTH, conv_sizes

# one H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet); the net
# runs in float32 with TF32 off, outside the tensor cores
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def forward_flops(cfg: dict) -> float:
    """FLOPs of one agent's forward at one step."""
    C, ch, H, A = (cfg["obs_channels"], cfg["conv_channels"],
                   cfg["rnn_hidden"], cfg["n_actions"])
    f, cin = 0.0, C
    for size in conv_sizes(cfg["fov"]):
        f += size * size * ch * cin * 9 * 2
        cin = ch
    vec = 2 + (A if cfg["last_action"] else 0)
    f += vec * MLP_WIDTH * 2
    gru_in = conv_sizes(cfg["fov"])[-1] ** 2 * ch + MLP_WIDTH
    f += (gru_in * 3 * H + H * 3 * H) * 2
    f += H * A * 2
    return f


def rollout_flops(cfg: dict, chips: int, T: int) -> float:
    """A rollout of ``chips`` over T steps: every chip's agents forward at
    every step, ended episodes included, as the actor loop runs them."""
    return forward_flops(cfg) * chips * cfg["n_droplets"] * T


def update_flops(cfg: dict, T: int) -> float:
    """One learner update over ``batch_size`` episodes of T steps."""
    return 4.0 * forward_flops(cfg) * cfg["batch_size"] * cfg["n_droplets"] * T


def cycle_flops(cfg: dict, chips: int, T: int) -> float:
    """A training cycle: its rollout and its updates."""
    return (rollout_flops(cfg, chips, T)
            + cfg["updates_per_cycle"] * update_flops(cfg, T))


def dmfb_step_bytes(cfg: dict, chips: int) -> int:
    """Least bytes one DMFB step of ``chips`` moves through device memory:
    each input byte it needs read once, each output byte written once.

    Read: the positions, goals and distances, the actions and move draws,
    the two counters, the usage board (added to), the health under each
    droplet (one 32-byte sector each: a move reads its own cell's) and the
    block mask under each droplet's candidate cell and in the fov rows of
    the observed corner [0, fov)^2 (one sector each, at most the board).
    Written: the new positions, distances, usage board and counters, the
    v0 observations, the rewards and dones, and the per-chip team reward,
    terminated flag, constraint count and success."""
    n, wl, fov = cfg["n_droplets"], cfg["width"] * cfg["length"], cfg["fov"]
    obs_row = 3 * fov * fov + 2
    read = (8 * n + 8 * n + 4 * n          # pos, goal, dist
            + 4 * n + 4 * n                # actions, move draws
            + 4 + 4                        # step count, constraints so far
            + 4 * wl                       # usage
            + min(4 * wl, 32 * n)          # health under the droplets
            + min(wl, 32 * (n + fov)))     # block mask where it is read
    write = (8 * n + 4 * n + 4 * wl + 4 + 4   # pos, dist, usage, counters
             + n * obs_row                    # observations, int8
             + 4 * n + n                      # rewards, dones
             + 4 + 1 + 4 + 4)                 # team, terminated, counts
    return chips * (read + write)
