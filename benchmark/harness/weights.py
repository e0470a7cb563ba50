"""The weights of a run, made by the benchmark from the seed on the run's
device: one normal draw for all of them, scaled leaf by leaf by the rules
of the configuration's file, so that the program and the reference start
from the same numbers and neither makes them.

A rule is ``{"match": regex, "init": kind}`` (the first rule whose regex
finds the parameter's name applies). Kinds: ``ones``, ``zeros``, ``msra``
(a normal draw, std sqrt(2 / fan_out)) and ``xavier`` (std sqrt(2 /
(fan_in + fan_out))), where a weight is [out, in, *kernel]. Every normal
draw is clipped at two standard deviations.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch

from harness.seeds import sub_seed

CONSTANT = {"ones": 1.0, "zeros": 0.0}


def _std(kind: str, shape: Tuple[int, ...]) -> float:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 1 else shape[0]
    fan_out = shape[0] * receptive
    if kind == "msra":
        return math.sqrt(2.0 / fan_out)
    if kind == "xavier":
        return math.sqrt(2.0 / (fan_in + fan_out))
    raise ValueError(f"weight rule kind {kind!r}")


def plan(shapes: Dict[str, Tuple[int, ...]], rules: List[dict]) -> Dict[str, Tuple[str, float]]:
    """{name: (kind, value or std)} for every parameter; raises for one no rule
    matches."""
    out = {}
    for name, shape in shapes.items():
        rule = next((r for r in rules if re.search(r["match"], name)), None)
        if rule is None:
            raise KeyError(f"no weight rule matches {name}")
        kind = rule["init"]
        out[name] = (kind, CONSTANT[kind] if kind in CONSTANT else _std(kind, shape))
    return out


def make(shapes: Dict[str, Tuple[int, ...]], rules: List[dict], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights {name: tensor} on ``device`` from ``seed``."""
    kinds = plan(shapes, rules)
    drawn = [n for n in shapes if kinds[n][0] not in CONSTANT]
    total = sum(math.prod(shapes[n]) for n in drawn)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind, std = kinds[name]
        if kind in CONSTANT:
            out[name] = torch.full(shape, float(std), device=device)
        else:
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul_(std)
            at += size
    return out
