"""QMIX in the PyTorch port against the benchmark's plain reference
(``benchmark/reference/qmix.py``) on the CPU, from the same seeded weights,
at a small MEDA (30x60, 3 droplets, fov 19, batch 4):

* ``QMixer``, both variants, against the reference's mixer written from
  the layer equations;
* MEDA's ``global_state`` against the reference's painted boards, on
  random boards whose footprints overlap;
* the QMIX loss, the gradient of every agent and mixer leaf, and three
  Adam updates against the reference's.

No JAX here: the reference is the benchmark's, which decides ``correct``
on the card.
"""

import pytest
import torch

from benchmark import checks, harness
from benchmark.reference import net as ref_net
from benchmark.reference import qmix as ref_qmix
from marl_dmfb_tpu_torch.algos.qlearn import QLearner
from marl_dmfb_tpu_torch.config import get_train_args, make_env_from_args
from marl_dmfb_tpu_torch.models.networks import QMixer, build_agent_net

torch.set_num_threads(2)

FLAGS = ["meda", "--drop_num=3", "--alg=qmix", "--width=30", "--length=60",
         "--batch_size=4", "--buffer_size=8", "--device=cpu", "--mesh=off"]


def small():
    """The program's args and env, and the reference's values, of the
    small MEDA QMIX recipe."""
    args = get_train_args(FLAGS, pri=False)
    env = make_env_from_args(args)
    args.update_env_info(env.env_info())
    cfg = {"kind": "meda", "width": 30, "length": 60, "n_droplets": 3,
           "fov": 19, "obs_channels": args.obs_shape[0],
           "n_actions": args.n_actions,
           "conv_channels": args.hyper_hidden_dim,
           "rnn_hidden": args.rnn_hidden_dim,
           "last_action": args.last_action, "gamma": args.gamma,
           "lr": args.lr, "lr_decay_steps": 0, "lr_decay_alpha": 0.05,
           "grad_norm_clip": args.grad_norm_clip,
           "adam_betas": [0.9, 0.99], "adam_eps": 1e-8,
           "batch_size": args.batch_size, "state_dim": args.state_shape,
           "qmix_hidden": args.qmix_hidden_dim,
           "hyper_hidden": args.hyper_hidden_dim,
           "two_hyper_layers": args.two_hyper_layers}
    return args, env, cfg


@pytest.mark.parametrize("two_layers", [True, False],
                         ids=["two_hyper_layers", "one_hyper_layer"])
def test_qmixer_matches_the_reference(two_layers):
    _, _, cfg = small()
    cfg["two_hyper_layers"] = two_layers
    mixer = QMixer(3, cfg["state_dim"], cfg["qmix_hidden"],
                   cfg["hyper_hidden"], two_layers)
    w = ref_qmix.make_mixer_weights(cfg, 11, "cpu")
    harness.load_weights(w, [mixer])
    g = torch.Generator().manual_seed(3)
    b, T = 4, 7
    q = torch.randn((b, T, 3), generator=g) * 5.0
    s = torch.randint(0, 4, (b, T, cfg["state_dim"]), generator=g).float()
    with torch.no_grad():
        got = mixer(q, s)
        want = ref_qmix.mix(w, q.reshape(b * T, 3),
                            s.reshape(b * T, -1), cfg).view(b, T, 1)
    # the same float32 sums in another order (3,600-term dot products of
    # the hyper layers, a bmm against a sum of products): a few ulp of
    # joint Qs of order 1-10
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def overlapping_states(env, B: int, g: torch.Generator):
    """States whose droplets and destinations lie anywhere on the board,
    footprints overlapping (the env's tasks keep them apart)."""
    p = env.params
    state = env.init(B, g, "cpu")

    def points():
        x = torch.randint(2, p.length - 2, (B, p.n_droplets, 1), generator=g)
        y = torch.randint(2, p.width - 2, (B, p.n_droplets, 1), generator=g)
        return torch.cat([x, y], -1).int()

    return state._replace(center=points(), dest=points())


def test_global_state_matches_the_reference():
    _, env, cfg = small()
    g = torch.Generator().manual_seed(5)
    state = overlapping_states(env, 64, g)
    # a pair of droplets on the same center and one a cell apart: the
    # largest id covers the shared cells
    state.center[0, 1] = state.center[0, 0]
    state.center[0, 2] = state.center[0, 0] + torch.tensor([1, 0]).int()
    got = env.global_state(state)
    want = ref_qmix.global_state(cfg, state._asdict())
    assert got.dtype == want.dtype == torch.int8
    assert got.shape == (64, cfg["state_dim"])
    assert torch.equal(got, want)
    boards = got.view(64, 2, 30, 60)
    assert (boards[0, 0] == 3).sum() == 25   # the largest id's body whole
    assert (boards[0, 0] == 1).sum() == 0    # covered by ids 2 and 3


def test_state_mismatch_counts_the_program_rollouts_states():
    """The reference replays a QMIX rollout's states from its start, the
    stored actions and the move draws: none differs, and an altered one
    counts."""
    from benchmark.reference import rollout as ref_rollout
    from marl_dmfb_tpu_torch.rollout import make_rollout

    args, env, cfg = small()
    net = build_agent_net(args)
    start = {}
    observe = env.observe

    def recorded(state):
        start["state"], start["gen"] = state, gen.get_state()
        return observe(state)

    env = env._replace(observe=recorded)
    rollout = make_rollout(env, net, args.rnn_hidden_dim, with_state=True)
    gen = torch.Generator().manual_seed(8)
    res = rollout(env.init(3, gen, "cpu"), gen, 0.3, 0.0, 0.3)
    ep = res.episodes
    T = ep["u"].shape[1]
    _, _, uniforms = ref_rollout.draws(start["gen"], "cpu", T, 3, 3, 9)
    args_ = (cfg, start["state"]._asdict(), uniforms)
    assert ref_qmix.state_mismatch(*args_, ep["s_ext"], ep["u"][..., 0]) == 0
    s = ep["s_ext"].clone()
    s[1, T // 2, 7] += 1
    assert ref_qmix.state_mismatch(*args_, s, ep["u"][..., 0]) == 1


def batches(env, cfg, n: int, g: torch.Generator) -> list:
    b, T, N = cfg["batch_size"], env.episode_limit, 3
    out = []
    for _ in range(n):
        padded = torch.rand((b, T, 1), generator=g) < 0.3
        out.append({
            "o_ext": torch.randint(-3, 4, (b, T + 1, N, env.params.obs_dim),
                                   generator=g, dtype=torch.int8),
            "u": torch.randint(0, 9, (b, T, N, 1), generator=g),
            "r": torch.randn((b, T, 1), generator=g),
            "padded": padded, "terminated": padded.clone(),
            "s_ext": torch.randint(0, 4, (b, T + 1, cfg["state_dim"]),
                                   generator=g, dtype=torch.int8)})
    return out


def program(args, cfg, w0, m0):
    net = build_agent_net(args)
    mixer = QMixer(3, cfg["state_dim"], cfg["qmix_hidden"],
                   cfg["hyper_hidden"], cfg["two_hyper_layers"])
    harness.load_weights(w0, [net])
    harness.load_weights(m0, [mixer])
    return QLearner(args, net, mixer)


def test_loss_gradients_and_updates_match_the_reference():
    args, env, cfg = small()
    w0 = ref_net.make_weights(cfg, 4, "cpu")
    m0 = ref_qmix.make_mixer_weights(cfg, 6, "cpu")
    wm0 = ref_qmix.joined(w0, m0)
    data = batches(env, cfg, 3, torch.Generator().manual_seed(2))
    learner = program(args, cfg, w0, m0)
    assert set(learner.all_params) == set(wm0)

    loss, grads = learner.loss_and_grads(data[0])
    w = {k: v.clone().requires_grad_(True) for k, v in wm0.items()}
    want = ref_qmix.td_loss(w, wm0, data[0], cfg)
    want_g = dict(zip(w, torch.autograd.grad(want, list(w.values()))))
    # one float32 loss summed in another order (the sequence GRU against
    # the per-step cell, a bmm against a sum of products)
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                 rel=1e-5)
    # every leaf, agent and mixer: the same gradient to float32 rounding
    # of sums over 4 x 90 rows, within a millionth of the whole
    # gradient's norm (the clip's scale) or 1e-4 of the leaf's own
    total = float(torch.sqrt(sum((g * g).sum() for g in want_g.values())))
    for k, g in want_g.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-4,
                                   atol=1e-6 * total, msg=k)

    losses = [float(learner.update(batch)) for batch in data]
    losses_r, g1, w3 = ref_qmix.updates(wm0, data, cfg)
    assert losses == pytest.approx(losses_r, rel=1e-5)
    # Adam turns round-off in a near-zero gradient into up to a step of
    # lr elementwise, so the weights' change is held by each leaf's norm,
    # as the cells' check holds it
    w3_p = {k: p.detach() for k, p in learner.all_params.items()}
    keep = checks.kept_leaves(g1)
    assert any(k.startswith(ref_qmix.MIXER) for k in keep)
    assert checks.leaf_gap({k: w3_p[k] - wm0[k] for k in keep},
                           {k: w3[k] - wm0[k] for k in keep}, keep) < 1e-5


def test_each_update_from_the_programs_state_matches_the_reference():
    """``steps_from``, the cell's judgement: each reference update taken
    from the program's weights and Adam moments before it.  From the start
    it is :func:`updates`' first update, bitwise; from the program's
    states each update's loss and change of the weights are the
    program's to float32 round-off."""
    args, env, cfg = small()
    w0 = ref_net.make_weights(cfg, 4, "cpu")
    m0 = ref_qmix.make_mixer_weights(cfg, 6, "cpu")
    wm0 = ref_qmix.joined(w0, m0)
    data = batches(env, cfg, 3, torch.Generator().manual_seed(3))
    zeros = {k: torch.zeros_like(v) for k, v in wm0.items()}

    losses_1, g1_1, w1 = ref_qmix.updates(wm0, data[:1], cfg)
    losses, g1, stepped = ref_qmix.steps_from([(wm0, zeros, zeros)],
                                              data[:1], wm0, cfg)
    assert losses == losses_1
    for k in wm0:
        assert torch.equal(g1[k], g1_1[k]), k
        assert torch.equal(stepped[0][k], w1[k]), k

    learner = program(args, cfg, w0, m0)
    starts, losses_p, after_p = [(wm0, zeros, zeros)], [], []
    for batch in data:
        losses_p.append(float(learner.update(batch)))
        after = {k: p.detach().clone()
                 for k, p in learner.all_params.items()}
        after_p.append(after)
        starts.append((after, learner.opt_state["mu"],
                       learner.opt_state["nu"]))
    starts = starts[:-1]
    losses_r, g1_r, after_r = ref_qmix.steps_from(starts, data, wm0, cfg)
    # the same float32 loss summed in another order, from the same weights
    assert losses_p == pytest.approx(losses_r, rel=1e-5)
    keep = checks.kept_leaves(g1_r)
    for (w, _, _), wp, wr in zip(starts, after_p, after_r):
        assert checks.leaf_gap({k: wp[k] - w[k] for k in keep},
                               {k: wr[k] - w[k] for k in keep}, keep) < 1e-5
    # the loss each step leaves on its minibatch: the program's steps and
    # the reference's leave it alike, to float32 round-off of the loss
    # (the recipe's first step overshoots: the loss rises tenfold and more,
    # and later steps bring it down), and a step of the same size against
    # the gradient leaves it far from there
    left_r = ref_qmix.losses_at(after_r, data, wm0, cfg)
    left_p = ref_qmix.losses_at(after_p, data, wm0, cfg)
    assert left_p == pytest.approx(left_r, rel=1e-5)
    flipped = [{k: 2 * w[k] - wr[k] for k in wr}
               for (w, _, _), wr in zip(starts, after_r)]
    left_f = ref_qmix.losses_at(flipped, data, wm0, cfg)
    assert all(abs(f - r) > 0.1 * r for f, r in zip(left_f, left_r))
