"""AdamW (the program's ``solver/optimizer.py Adam`` with ``decoupled``):
the first gradient as the optimizer received it, after its clip, read from
the optimizer's state after one step. That step's first moment is ``(1 -
b1) g`` (the moment starts at 0, and the weight decay joins after Adam).

``SILENT``: the share of the median leaf's first gradient under which a
leaf is left out of the comparison of the parameters' change. Adam's first
update is close to ``lr * sign(g)`` for every element whatever its size, so
a leaf whose gradient is rounding noise moves by about lr in a direction
the noise picks, in the program and in the reference alike: its change
tells nothing of the step. Set from the calibration readings (PERF.md).
"""

SILENT = 1e-3


def received(opt_state, start, wds, solver):
    b1 = solver["betas"][0]
    return {n: m / (1.0 - b1) for n, m in opt_state["mu"].items()}
