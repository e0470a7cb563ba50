"""SGD with coupled weight decay and a momentum trace (the program's
SGDLars without LARS): the first gradient as the program's optimizer
received it, after its clip, read from the optimizer's state after one
step. That step's trace is the gradient plus ``wd * p`` at the start.

``SILENT``: no leaf is left out of the comparison of the parameters'
change. SGD moves a leaf by its gradient's size, so one whose gradient is
nought to rounding moves by next to nothing, and its gap, measured against
the median leaf's change, stays small (under Adam, which moves every leaf
by about the rate, such leaves move by round-off alone and are left out).
"""

SILENT = 0.0


def received(opt_state, start, wds, solver):
    return {n: t - wds[n] * start[n] for n, t in opt_state["trace"].items()}
