"""The control at a size a test run holds: the plain reference in the
program's place, in the precision below the configuration's, reads above
the program on the numbers it is meant to fail. The readings at the cells'
own sizes come from ``benchmark/control.py`` on the card."""

import torch

import harness
from conftest import TINY_SAMPLE, TINY_VAL_GEN


def readings(cfg, traffic, control, seed):
    run = harness.Run(cfg, dict(traffic), seed, torch.device("cpu"))
    drv = harness.loop(traffic["loop"])
    st = drv.setup(run)
    drv.step(run, st, 0)
    return drv.check(run, st, control=control)[0]


def test_generation_control_separates(tiny):
    for seed in (11, 2**31 + 12):
        program = readings(tiny(), TINY_SAMPLE, False, seed)
        control = readings(tiny(), TINY_SAMPLE, True, seed)
        assert control["gen_rel_l2"] > 3 * program["gen_rel_l2"], (program, control)


def test_protocol_control_separates(tiny):
    program = readings(tiny(npoints=64), TINY_VAL_GEN, False, 21)
    control = readings(tiny(npoints=64), TINY_VAL_GEN, True, 21)
    assert control["gen_rel_l2"] > 3 * program["gen_rel_l2"], (program, control)
    assert control["cd_rel"] > 3 * program["cd_rel"], (program, control)
