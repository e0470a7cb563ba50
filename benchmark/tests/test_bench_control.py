"""The comparison fails what it has to: the control (the reference
computed in the precision below bf16 that the configuration's ``control``
names, in the program's place) and each fault a training cell
can have, planted under a whole run of a tiny cell on the CPU; a sound run
passes. (One card: no exchange between chips to leave out. A training
step produces no answer to alter.)"""

import time

import pytest
import torch

import tiny
from harness import cell, check, inputs, manifest

CPU = torch.device("cpu")


def _run(plant=None, seed=21):
    return cell.run(tiny.speed_ctx(), seed, 0.2, False, CPU, time.perf_counter(), plant)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [3, 2**32 + 9])
def test_the_control_is_not_correct(seed):
    ctx = tiny.speed_ctx()
    ref = manifest.reference(ctx.spec["reference"])
    pool = inputs.make_pool(ctx.traffic, seed, CPU)
    want = cell.reference_readings(ref, ctx.spec, ctx.traffic, pool, seed, CPU)
    control = cell.reference_readings(ref, ctx.spec, ctx.traffic, pool, seed, CPU, ctx.spec["control"])
    assert not check.judge(check.numbers(control, want), ctx.traffic["limits"])


@pytest.mark.parametrize("witness", ["bf16", "bf16fold"])
def test_the_witnesses_read_below_the_control(witness):
    ctx = tiny.speed_ctx()
    ref = manifest.reference(ctx.spec["reference"])
    pool = inputs.make_pool(ctx.traffic, 3, CPU)
    want = cell.reference_readings(ref, ctx.spec, ctx.traffic, pool, 3, CPU)
    control = check.numbers(cell.reference_readings(ref, ctx.spec, ctx.traffic, pool, 3, CPU, ctx.spec["control"]),
                            want)
    seen = check.numbers(cell.reference_readings(ref, ctx.spec, ctx.traffic, pool, 3, CPU, witness), want)
    assert seen["grad1"] < control["grad1"], (seen, control)


def _state_unchanged(prog):
    step = prog.step

    def frozen(state, clips, infos, gen, lr):
        params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        opt = state.opt_state
        stats = step(state, clips, infos, gen, lr)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(params[n])
        state.opt_state = opt
        return stats

    prog.step = frozen


def _half_batch(prog):
    step = prog.step

    def half(state, clips, infos, gen, lr):
        b = clips.shape[0] // 2
        return step(state, clips[:b], {k: v[:b] for k, v in infos.items()}, gen, lr)

    prog.step = half


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_planted_fault_is_not_correct(fault):
    res = _run(fault)
    assert not res["correct"], res["checks"]
