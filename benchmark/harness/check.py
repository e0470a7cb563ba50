"""The comparison that decides ``correct`` for a training cell.

Two numbers, each against its limit from the cell's file:

- ``grad1``: over the leaves, the largest gap between the program's and
  the reference's norms of the first gradient as the optimizer received
  it, each over the reference's norm of that leaf or of the median leaf,
  whichever is larger; the median is taken over the leaves whose
  reference norm is not zero, so that leaves held at exactly zero (the
  residual branches behind a final BN scale that starts at 0) are measured
  against the leaves that move;
- ``change``: the same of each parameter's change over the checked steps,
  leaving out the leaves whose reference first gradient is under the
  solver's ``SILENT`` share of the median leaf's (``benchmark/solvers/``:
  under Adam, a thousandth, since such leaves move by round-off alone;
  under SGD none, since a leaf moves by its gradient's size and the median
  floor holds the gap of one that hardly moves small).

Two more readings, the first step's loss gap (``loss0``) and the gap of the
whole first gradient (``grad1_dir``, the norm of the difference over the
reference's norm), are given by :func:`details` for calibration and are not
compared: neither the control nor a fault reads three times what sound
runs read (``PERF.md``).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch


def _median(values) -> float:
    """The median of the values that are not zero (0 if none is)."""
    return statistics.median([v for v in values if v > 0] or [0.0])


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> List[tuple]:
    """(gap, name) of each leaf, sorted."""
    floor = _median(ref[n] for n in names)
    return sorted((abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30), n) for n in names)


def moving(ref: dict) -> List[str]:
    """The leaves ``change`` compares: ``ref["silent"]`` is the solver's
    share of the median leaf's first gradient under which a leaf is left
    out."""
    med = _median(ref["grad1"].values())
    return [n for n, g in ref["grad1"].items() if g >= ref["silent"] * med]


def _worst_gap(prog, ref, names) -> float:
    gaps = [g for g, _ in leaf_gaps(prog, ref, names)]
    return gaps[-1] if all(math.isfinite(g) for g in gaps) else math.inf


def direction_gap(prog_g: Dict, ref_g: Dict) -> float:
    """||g_program - g_reference|| / ||g_reference|| over all leaves, the
    program's leaves brought to the reference's device one at a time."""
    num = den = 0.0
    for n, r in ref_g.items():
        r = r.double()
        num += float(torch.sum(torch.square(prog_g[n].to(r.device).double() - r)))
        den += float(torch.sum(torch.square(r)))
    gap = math.sqrt(num / den) if den > 0 else math.inf
    return gap if math.isfinite(gap) else math.inf


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    return {"grad1": _worst_gap(prog["grad1"], ref["grad1"], list(ref["grad1"])),
            "change": _worst_gap(prog["change"], ref["change"], moving(ref))}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k] for k in limits)


def silent_leaves(ref: dict):
    return sorted(set(ref["grad1"]) - set(moving(ref)))


def details(prog: dict, ref: dict) -> dict:
    """For calibration: each step's loss gap, ``grad1_dir``, and of
    ``grad1`` and ``change`` the worst, 90th-percentile and median leaf
    gaps with the worst leaf's name."""
    out = {"loss_steps": [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])],
           "grad1_dir": direction_gap(prog["g1"], ref["g1"])}
    for key, names in (("grad1", list(ref["grad1"])), ("change", moving(ref))):
        gaps = leaf_gaps(prog[key], ref[key], names)
        out[key] = {"worst": gaps[-1][0], "worst_leaf": gaps[-1][1], "p90": gaps[int(0.9 * (len(gaps) - 1))][0],
                    "median": gaps[len(gaps) // 2][0]}
    return out
