"""One run of one benchmark cell of ``advise_tpu_torch`` on the card(s) of
this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), ending in ``checks``: each number the
comparison with the plain reference read, beside its limit; the same
numbers close standard error. With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. Exits
non-zero, printing no result, without enough CUDA cards, and if the JAX
package, ``jax``, ``jaxlib`` or ``flax`` is loaded once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "advise_tpu")


def set_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def end_to_end(ctx, res: dict) -> dict:
    from harness.inputs import clips_per_step

    win = res["window"]
    values = {
        "clips_per_s": clips_per_step(ctx.traffic) * win["steps"] / win["seconds"],
        "step_ms_p90": statistics.quantiles(win["step_ms"], n=10, method="inclusive")[-1]
        if len(win["step_ms"]) > 1 else None,
        "peak_mem_gib": win["peak_bytes"] / 2**30,
        "setup_s": res["setup_s"],
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in ctx.end_to_end
            if values.get(m["name"]) is not None}


def per_layer(ctx, record: dict) -> dict:
    from harness import manifest

    out = {}
    for m in ctx.per_layer:
        value = manifest.reader(m["name"], ROOT).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(ctx, res: dict, trace: bool, dev: dict) -> dict:
    """The result's JSON object: ``checks`` last."""
    from harness import trace as tracing

    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"]}
    if trace:
        record = res["record"]
        busy, _ = tracing.busy_and_gaps(record["device"])
        dev = dict(dev, busy_s=busy, window_s=record["wall_s"])
        line["metrics"] = per_layer(ctx, record)
        line["breakdown"] = tracing.breakdown(record)
    else:
        line["metrics"] = end_to_end(ctx, res)
    line["device"] = dev
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    sys.path.insert(0, str(ROOT))  # the measured package
    import torch

    from harness import cell, manifest

    ctx = manifest.resolve(manifest.load_manifest(ROOT), args.workload, ROOT)
    chips = int(ctx.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = cell.run(ctx, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"run: modules the benchmark may not load are loaded: {found}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": res["window"]["peak_bytes"], "card": card_line()}
    line = result_line(ctx, res, bool(args.trace), dev)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
