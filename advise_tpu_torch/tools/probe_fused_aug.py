"""Where the fused simple aug's time goes (K3, csrc/fused_aug.cu), on one
NVIDIA card, at SpeedPro's shape: uint8 clips [32, 8, 256, 320, 3] (8 videos
x 4 clips of 8 frames at the preset's ingest geometry), crop 224.

    python3 -m advise_tpu_torch.tools.probe_fused_aug [--parent DIR]

1. The wrapper ``fused_simple_aug`` of this tree, and with ``--parent`` that
   of another checkout of the repo (DIR, its root), in turns (parent, this
   tree, this tree, parent), each in a process of its own, on the same
   inputs: the colour probability p at 0 (no clip runs the chain, and K3
   skips the contrast mean), SpeedPro's 0.8 and 1, float32 and bf16 out.
   Those input variants are the probe that needs no change to a kernel.
2. This tree's kernel built with FUSED_AUG_SKIP (the source note says what
   each bit compiles out) at p = 1, float32 out: what each part costs; and
   built with FUSED_AUG_MIN_BLOCKS 4 and 5 (more registers a thread, fewer
   resident CTAs), each with its registers and spills.

Each time is the median of 20 samples of 10 calls back to back between two
CUDA events, per call, queued behind ``torch.cuda._sleep`` so that the card
starts them only once the host has queued all ten: the card's time for the
calls, not the wrapper's host work (printed beside it: the host's time a
call, from the same samples); beside it the byte bound (the window read
once, the output written once, at 3.35 TB/s). No card, no run: it exits
non-zero. Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE, CROP = (32, 8, 256, 320, 3), 224
MEAN, STD = (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)  # the config's DATA.MEAN / STD defaults
COLORS = {"p 0": (0.0, 0.2, 0.2, 0.2, 0.1), "p 0.8": (0.8, 0.2, 0.2, 0.2, 0.1),
          "p 1": (1.0, 0.2, 0.2, 0.2, 0.1)}
SKIPS = {"full": 0, "no luma sum": 1, "no chain": 2, "no normalisation": 4, "no staging": 8,
         "stores only": 15}
MIN_BLOCKS = (4, 5)  # FUSED_AUG_MIN_BLOCKS variants of the full kernel (6 in the library)
HBM_BYTES_PER_S = 3.35e12
SAMPLES, REPS = 20, 10
SLEEP_CYCLES = 10_000_000  # ~5 ms at 1980 MHz: longer than the host takes to queue REPS calls

# (card ms, host ms) a call of fn: the module-level source is also run in the
# other checkout's process
_TIMING = f"""
import statistics, time, torch


def card_and_host_ms(fn):
    fn()
    torch.cuda.synchronize()
    card, host = [], []
    for _ in range({SAMPLES}):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep({SLEEP_CYCLES})
        a.record()
        t0 = time.perf_counter()
        for _ in range({REPS}):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / {REPS})
        b.record()
        b.synchronize()
        card.append(a.elapsed_time(b) / {REPS})
    return statistics.median(card), statistics.median(host)
"""

# run in the root of a checkout, so that it times that checkout's wrapper
_TIME_TREE = _TIMING + f"""
import json
from advise_tpu_torch.ops import fused_aug as fa
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
clips = torch.randint(0, 256, {SHAPE!r}, generator=g, device=dev, dtype=torch.uint8)
out = {{}}
for name, color in {COLORS!r}.items():
    prm = fa.sample_simple_aug({SHAPE[0]}, {SHAPE[2]}, {SHAPE[3]}, {CROP}, color,
                               torch.Generator(device=dev).manual_seed(1))
    for dt in (torch.float32, torch.bfloat16):
        fn = lambda: fa.fused_simple_aug(clips, prm, {CROP}, {MEAN!r}, {STD!r}, dt)
        out[f"{{name}} {{str(dt).split('.')[1]}}"] = card_and_host_ms(fn)
print("TIMES " + json.dumps(out))
"""


def bound_ms(out_bytes_per_value: int) -> float:
    n, t, _, _, c = SHAPE
    values = n * t * CROP * CROP * c
    return (values + values * out_bytes_per_value) / HBM_BYTES_PER_S * 1e3


def time_tree(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TIME_TREE], cwd=root, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TIMES ")][-1]
    return json.loads(line[len("TIMES "):])


def time_variants() -> dict:
    """This tree's kernel with each FUSED_AUG_SKIP mask, p = 1, float32."""
    import ctypes

    import torch

    from advise_tpu_torch.ops import build
    from advise_tpu_torch.ops import fused_aug as fa

    timing = {}
    exec(_TIMING, timing)
    flags = {name: (f"-DFUSED_AUG_SKIP={bits}",) for name, bits in SKIPS.items()}
    flags.update({f"min blocks {b}": (f"-DFUSED_AUG_MIN_BLOCKS={b}",) for b in MIN_BLOCKS})
    builds = {name: build.build_all([fa.SOURCE], extra=extra)[fa.SOURCE][0]
              for name, extra in flags.items()}
    for name, extra in flags.items():
        use = build.ptxas_usage(fa.SOURCE, extra)
        print(f"[probe] {name}: registers a thread by instance {sorted(u['registers'] for u in use.values())}, "
              f"spill bytes {sum(u['spill_stores'] + u['spill_loads'] for u in use.values())}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    clips = torch.randint(0, 256, SHAPE, generator=g, device=dev, dtype=torch.uint8)
    prm = fa.sample_simple_aug(SHAPE[0], SHAPE[2], SHAPE[3], CROP, COLORS["p 1"],
                               torch.Generator(device=dev).manual_seed(1))
    ints = {k: prm[k].to(dev, torch.int32).contiguous() for k in ("tops", "lefts", "apply", "order")}
    floats = {k: prm[k].to(dev, torch.float32).contiguous() for k in ("bfac", "cfac", "sfac")}
    out = {}
    for name, path in builds.items():
        lib = ctypes.CDLL(str(path))
        fa.set_argtypes(lib)
        out[name] = timing["card_and_host_ms"](
            lambda: fa.launch(lib, clips, ints, floats, CROP, MEAN, STD, torch.float32))
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="the root of another checkout, timed in turns with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_fused_aug: no CUDA card; K3 runs on a card only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    here = Path(__file__).resolve().parents[2]
    print(f"[probe] K3 at clips {SHAPE} uint8, crop {CROP}; bound {bound_ms(4)} ms (float32 out), "
          f"{bound_ms(2)} ms (bf16 out)")
    order = [("this tree", here), ("this tree", here)]
    if args.parent is not None:
        order = [("parent", args.parent.resolve())] + order + [("parent", args.parent.resolve())]
    runs = {}
    for label, root in order:
        times = time_tree(root)
        runs.setdefault(label, []).append(times)
        print(f"[probe] {label} ({root}): " + ", ".join(
            f"{k} {card} ms (host {host} ms a call)" for k, (card, host) in times.items()))
    for label, samples in runs.items():
        for key in samples[0]:
            vals = [s[key][0] for s in samples]
            b = bound_ms(4 if key.endswith("float32") else 2)
            print(f"[probe] {label} {key}: {min(vals)}-{max(vals)} ms over {len(vals)} runs, "
                  f"{b / min(vals)} of the bound at best")
    for name, (card_ms, host_ms) in time_variants().items():
        print(f"[probe] this tree, {name}, p 1 float32: {card_ms} ms (host {host_ms} ms a call)")
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
