"""Run the nine probe windows of ``scripts/probe_mosaic_aot.py`` (P1-P9) on
the card through the CUDA window gather and hold each against its plain
PyTorch version:

    python -m advise_tpu_torch.tools.probe_windows

The script fed its probes zeros; here each input is drawn from seed
:data:`SEED` (float32 normal, or uniform uint8) so that a wrong window
shows. The offset is the script's ``o = 8`` (``off``, :61), except where
that window is out of range: at 8, P1's two-slice
window [8, 10) of its 8-long leading axis is one the TPU DMA could not
read, so the port raises there, and P1 runs at 6, its last in-range
offset (:func:`probe_offsets`). Prints
one line per probe (shape, max abs difference, equal) and exits non-zero
when any probe differs. Without a card it exits non-zero: the probes have
no CPU mode here.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch

from advise_tpu_torch.ops import window_probe as wp

OFFSET = 8  # the script's runtime offset ``o``
SEED = 0


def probe_inputs(device) -> Dict[str, torch.Tensor]:
    """Each probe's input at the script's shape, drawn from :data:`SEED`."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    inputs = {}
    for name, win in wp.WINDOWS.items():
        if win.dtype == torch.uint8:
            x = torch.randint(0, 256, win.shape, generator=g, dtype=torch.uint8)
        else:
            x = torch.randn(win.shape, generator=g)
        inputs[name] = x.to(device)
    return inputs


def probe_offsets() -> Dict[str, int]:
    """Each probe's offset: :data:`OFFSET`, or for a probe whose window lies
    outside its input there, the largest in-range offset below it."""
    offsets = {}
    for name, win in wp.WINDOWS.items():
        p = OFFSET
        while True:
            try:
                wp.check_in_range(win, (p, p))
                break
            except IndexError:
                if p <= 0:
                    raise
                p -= 1
        offsets[name] = p
    return offsets


def run(inputs: Dict[str, torch.Tensor]):
    """{probe: (offset, kernel output, plain output)} at :func:`probe_offsets`."""
    out = {}
    for name, p in probe_offsets().items():
        x = inputs[name]
        out[name] = (p, wp.ENTRIES[name](p, x), wp.window_plain(wp.WINDOWS[name], x, (p, p)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_windows: no CUDA card; the window kernel runs on a card only", file=sys.stderr)
        return 1
    results = run(probe_inputs(torch.device("cuda", 0)))
    torch.cuda.synchronize()
    bad = 0
    for name, (p, got, want) in results.items():
        equal = torch.equal(got, want)
        bad += not equal
        print(f"[probe] {name} o={p}: {tuple(got.shape)} float32, max abs diff "
              f"{float((got - want).abs().max())}, equal {equal}")
    print(f"[probe] {len(results) - bad} of {len(results)} probes equal their plain versions "
          f"on {torch.cuda.get_device_name(0)}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
