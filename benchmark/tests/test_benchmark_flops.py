"""The yardstick's arithmetic against counts by hand."""

import json

from benchmark import flops
from benchmark.harness import HERE, reference_config


def config(name):
    return reference_config(json.loads(
        (HERE / "configs" / f"{name}.json").read_text()))


def test_forward_flops_flagship():
    # fov 9: two 3x3 convs to 7x7 and 5x5 of 24 channels, the 7-wide
    # vector (2 + 5 actions) into 10, a GRU of 128 over 25*24 + 10, 5 Qs
    hand = (7 * 7 * 24 * 3 * 9 * 2 + 5 * 5 * 24 * 24 * 9 * 2 + 7 * 10 * 2
            + (610 * 384 + 128 * 384) * 2 + 128 * 5 * 2)
    assert hand == 890_908
    assert flops.forward_flops(config("dmfb_20x20_4d_fov9_vdn")) == hand


def test_forward_flops_meda80():
    # fov 19: convs of stride 2, 1, 1 to 9x9, 7x7, 5x5 of 32 channels,
    # the 11-wide vector (2 + 9 actions), a GRU over 25*32 + 10, 9 Qs
    hand = (9 * 9 * 32 * 3 * 9 * 2 + 7 * 7 * 32 * 32 * 9 * 2
            + 5 * 5 * 32 * 32 * 9 * 2 + 11 * 10 * 2
            + (810 * 384 + 128 * 384) * 2 + 128 * 9 * 2)
    assert flops.forward_flops(config("meda_80x80_10d_fov19_vdn")) == hand


def test_update_and_cycle_flops():
    cfg = config("dmfb_20x20_4d_fov9_vdn")
    f = 890_908
    assert flops.update_flops(cfg, 80) == 4 * f * 128 * 4 * 80
    assert flops.rollout_flops(cfg, 64, 80) == f * 64 * 4 * 80
    assert flops.cycle_flops(cfg, 64, 80) == (f * 64 * 4 * 80
                                              + 32 * 4 * f * 128 * 4 * 80)


def test_dmfb_step_bytes_by_hand():
    cfg = config("dmfb_20x20_4d_fov9_vdn")
    # read: pos 32, goal 32, dist 16, actions 16, draws 16, counters 8,
    # usage 1600, health 4 sectors 128, block mask min(400, 13 sectors)
    read = 32 + 32 + 16 + 16 + 16 + 8 + 1600 + 128 + 400
    # written: pos 32, dist 16, usage 1600, counters 8, observations
    # 4 * 245, rewards 16, dones 4, team 4, terminated 1, counts 8
    write = 32 + 16 + 1600 + 8 + 4 * 245 + 16 + 4 + 4 + 1 + 8
    assert read + write == 4_917
    assert flops.dmfb_step_bytes(cfg, 16384) == 16384 * 4_917
