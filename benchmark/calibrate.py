"""The readings that the limits of a training cell are set from, on the card
at the cell's own size, one JSON line a seed:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 [--program] [--precisions fp8 int8] [--half]

For each seed, against the float32 reference over the checked steps:
``--program`` the program's readings (its first steps, no window);
``--precisions`` the reference itself computed in each named precision
(``reference/common.py``: ``fp8`` and ``int8``, the precisions below the
configuration's bf16, one of which is its ``control``; ``bf16`` and
``bf16fold``, witnesses under bf16 autocast without and with batch
normalisation's bf16 fold); ``--half`` the reference with half of each
batch left out, the mean taken over the rest (a fault planted in the
reference put in the program's place). ``--own-start`` starts each residual branch's last BN scale at
1, the preset's own start, instead of the configuration's 0 (the look that
PERF.md records). The benchmark's runs never run this file.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--precisions", nargs="*", default=[])
    ap.add_argument("--half", action="store_true")
    ap.add_argument("--own-start", action="store_true", help="final BN scales at 1, the preset's start")
    ap.add_argument("--out", type=Path, default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import run
    from harness import cell, check, inputs, manifest, weights as wmod
    from harness.program import Program

    run.set_caches()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = manifest.resolve(manifest.load_manifest(ROOT), args.workload, ROOT)
    spec, traffic = ctx.spec, ctx.traffic
    if args.own_start:
        spec = dict(spec, weights=[{"match": r"branch2\.c_bn\.weight$", "init": "ones"}] + spec["weights"])
    ref = manifest.reference(spec["reference"])
    rspec = spec["reference_spec"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        pool = inputs.make_pool(traffic, seed, device)
        line = {"workload": args.workload, "seed": seed, "own_start": args.own_start}
        if args.program:
            start = wmod.make(ref.param_shapes(rspec), spec["weights"], seed, device)
            prog = Program(spec, traffic, seed, device)
            prog.load(start)
            got = cell.program_readings(prog, pool, spec, start, ref.weight_decays(rspec))
            prog.release()
            del prog, start
            cell.free(device)
        t1 = time.perf_counter()
        want = cell.reference_readings(ref, spec, traffic, pool, seed, device)
        line["reference_s"] = time.perf_counter() - t1
        line["reference_losses"] = want["losses"]
        line["silent_leaves"] = check.silent_leaves(want)
        if args.program:
            line["program"] = check.numbers(got, want)
            line["program_details"] = check.details(got, want)
            line["program_losses"] = got["losses"]
        for prec in args.precisions:
            other = cell.reference_readings(ref, spec, traffic, pool, seed, device, prec)
            line[prec] = check.numbers(other, want)
            line[prec + "_details"] = check.details(other, want)
        if args.half:
            half = cell.reference_readings(ref, spec, traffic, pool, seed, device, "fp32", True)
            line["half"] = check.numbers(half, want)
            line["half_details"] = check.details(half, want)
        line["seconds"] = time.perf_counter() - t0
        line["peak_bytes"] = torch.cuda.max_memory_allocated()
        text = json.dumps(line)
        print(text, flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del pool
        cell.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
