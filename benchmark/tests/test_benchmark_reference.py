"""The plain reference against the measured program at tiny sizes on the
CPU, from the same weights and states: the net, both env steps and the
learner's updates."""

import pytest
import torch

from benchmark import checks
from benchmark.reference import dmfb as ref_dmfb
from benchmark.reference import learner as ref_learner
from benchmark.reference import meda as ref_meda
from benchmark.reference import net as ref_net
from benchmark.tests.rehearsal import TINY, make_cell
from benchmark import harness


def setup(cell, seed=3):
    c = make_cell(cell)
    cfg = harness.reference_config(c.config, TINY[cell])
    args = harness.program_args(c.config, seed, "cpu", overrides=TINY[cell])
    return cfg, args


def program_env(args):
    from marl_dmfb_tpu_torch.config import make_env_from_args
    env = make_env_from_args(args)
    args.update_env_info(env.env_info())
    return env


def test_net_matches_the_program():
    from marl_dmfb_tpu_torch.models.networks import build_agent_net
    for cell in ("flagship.collect", "meda80.train"):
        cfg, args = setup(cell)
        program_env(args)
        net = build_agent_net(args)
        w = ref_net.make_weights(cfg, 5, "cpu")
        harness.load_weights(w, [net])
        x = torch.randn(12, ref_net.input_dim(cfg))
        h = torch.randn(12, cfg["rnn_hidden"])
        q, h2 = net(x, h)
        qr, hr = ref_net.forward(w, x, h, cfg)
        torch.testing.assert_close(qr, q, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(hr, h2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell,ref", [("flagship.collect", ref_dmfb),
                                      ("meda80.train", ref_meda)])
def test_env_step_matches_the_program(cell, ref):
    cfg, args = setup(cell)
    env = program_env(args)
    g = torch.Generator().manual_seed(9)
    state = env.init(16, g, "cpu")
    for _ in range(12):
        actions = torch.randint(0, env.n_actions, (16, env.n_agents),
                                generator=g, dtype=torch.int32)
        uniforms = torch.rand((16, env.n_agents), generator=g)
        new, out = env.step_core(state, actions, uniforms)
        s = state._asdict()
        assert ref.start_faults(cfg, env.reset(state, g)._asdict()) == 0
        rnew, rout = ref.step(cfg, s, actions, uniforms)
        assert torch.equal(rout["obs"], out.obs)
        for k in ("rewards", "team_reward", "terminated", "constraints",
                  "success"):
            assert torch.equal(rout[k], getattr(out, k)), k
        for k, v in new._asdict().items():
            assert torch.equal(rnew[k], v), k
        state = new


def test_learner_matches_the_program():
    from marl_dmfb_tpu_torch.algos.qlearn import QLearner
    from marl_dmfb_tpu_torch.models.networks import build_agent_net
    cfg, args = setup("dmfb10-2d.train.mesh4")
    env = program_env(args)
    net = build_agent_net(args)
    w0 = ref_net.make_weights(cfg, 4, "cpu")
    harness.load_weights(w0, [net])
    learner = QLearner(args, net)
    g = torch.Generator().manual_seed(2)
    b, T, N = cfg["batch_size"], env.episode_limit, env.n_agents
    obs = env.params.obs_dim
    batches = []
    for _ in range(3):
        padded = torch.rand((b, T, 1), generator=g) < 0.3
        batches.append({
            "o_ext": torch.randint(-3, 4, (b, T + 1, N, obs), generator=g,
                                   dtype=torch.int8),
            "u": torch.randint(0, 5, (b, T, N, 1), generator=g),
            "r": torch.randn((b, T, 1), generator=g),
            "padded": padded, "terminated": padded.clone()})
    losses = [float(learner.update(batch)) for batch in batches]
    losses_r, _, w3 = ref_learner.updates(w0, batches, cfg)
    assert losses == pytest.approx(losses_r, rel=1e-5)
    # elementwise, Adam turns round-off in a near-zero gradient into up
    # to a step of lr, so the weights' change is held by the norm of each
    # leaf's change, as the cells' check holds it
    w3_p = {k: p.detach() for k, p in learner.params.items()}
    keep = list(w0)
    assert checks.leaf_gap({k: w3_p[k] - w0[k] for k in keep},
                           {k: w3[k] - w0[k] for k in keep}, keep) < 1e-5
