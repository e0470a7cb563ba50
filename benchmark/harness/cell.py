"""One run of one cell: set-up, the checked first steps, the measured window,
with ``trace`` the traced steps, then the reference and the comparison.

Order, as the benchmark's contract sets it:

1. set-up: the reference's parameter names and shapes (on the meta
   device), the weights and the batch pool from the seed, the program's
   state and step, the weights loaded;
2. steps 0-2 through the program's own call on batches 0-2, reading each
   loss, the first gradient as the optimizer received it and each
   parameter's change over the three; they are also the warm-up, so every
   shape the window uses has run;
3. the window (``harness/window.py``) from step 3 on, for ``seconds``;
   with ``trace``, the aug's stream time around each step's aug call, then
   ``trace_steps`` more steps under the profiler;
4. the program freed, then the reference over steps 0-2 from the same
   weights, batches and step seeds, in float32, and the comparison.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Optional

import torch

from harness import check, inputs, manifest, trace as tracing, weights as wmod, window
from harness.program import Program
from reference.common import fp32_math, leaf_norms

CHECKED = 3  # steps compared with the reference


def program_readings(prog: Program, pool, spec: dict, start: dict, wds: dict) -> dict:
    """Steps 0..CHECKED-1 on the program, with what the comparison reads."""
    losses, grad1 = [], None
    for i in range(CHECKED):
        stats = prog.call(i, pool[i % len(pool)])
        losses.append(float(stats[spec["loss_stat"]]))
        if i == 0:
            received = prog.received(start, wds)
            grad1 = leaf_norms(received)
            g1 = {n: t.detach().to("cpu", copy=True) for n, t in received.items()}
            del received
    change = leaf_norms({n: p.detach() - start[n] for n, p in prog.params().items()})
    return {"losses": losses, "grad1": grad1, "change": change, "g1": g1}


def reference_readings(ref, spec: dict, traffic: dict, pool, seed: int, device, precision: str = "fp32",
                       half: bool = False) -> dict:
    """The reference's readings over the checked steps, with ``silent``, the
    share of the median leaf's first gradient under which the solver's
    reader leaves a leaf out of ``change``."""
    rspec = spec["reference_spec"]
    start = wmod.make(ref.param_shapes(rspec), spec["weights"], seed, device)
    with fp32_math():
        out = ref.run_steps(rspec, start, pool[:CHECKED], [inputs.step_seed(seed, i) for i in range(CHECKED)],
                            float(traffic["lr"]), device, precision, half)
    out["silent"] = manifest.solver(rspec["solver"]["method"]).SILENT
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(ctx, seed: int, seconds: float, trace: bool, device, t_start: float,
        plant: Optional[Callable[[Program], None]] = None) -> dict:
    """One run of the cell ``ctx`` (``manifest.resolve``). ``plant`` sees the
    program before its first step (the tests plant faults through it).
    Returns the result line's fields and, under ``checks``, each compared
    number with its limit."""
    spec, traffic = ctx.spec, ctx.traffic
    on_card = torch.device(device).type == "cuda"
    ref = manifest.reference(spec["reference"])
    rspec = spec["reference_spec"]
    shapes = ref.param_shapes(rspec)
    start = wmod.make(shapes, spec["weights"], seed, device)
    pool = inputs.make_pool(traffic, seed, device)
    prog = Program(spec, traffic, seed, device, aug_span=trace and on_card)
    prog.load(start)
    if plant is not None:
        plant(prog)
    wds = ref.weight_decays(rspec)
    got = program_readings(prog, pool, spec, start, wds)
    del start
    free(device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    def call(i):
        return prog.call(i, pool[i % len(pool)])

    win = window.run(call, CHECKED, seconds, spec["loss_stat"], on_card)
    record = None
    if trace:
        ops = tracing.host_ops(manifest.reader(m["name"]) for m in ctx.per_layer)
        record = tracing.profile(call, CHECKED + win["steps"], int(traffic["trace_steps"]), on_card, ops)
        aug_ms = prog.aug_span.ms()[CHECKED:CHECKED + win["steps"]] if prog.aug_span else []
        record.update(window=win, aug_ms=aug_ms, traffic=traffic, spec=spec)
    failed = sum(1 for x in torch.stack(win["losses"]).float().cpu().tolist() if not math.isfinite(x))
    prog.release()
    del prog, call
    free(device)
    want = reference_readings(ref, spec, traffic, pool, seed, device)
    nums = check.numbers(got, want)
    limits = traffic["limits"]
    return {"correct": check.judge(nums, limits), "attempted": win["steps"], "failed": failed,
            "setup_s": setup_s, "window": win, "record": record,
            "checks": {k: {"value": nums[k], "limit": limits[k]} for k in limits}}
