"""The run's command line and its last line: the keys the driver reads, in
order, ``checks`` last; no result without a card or without the program."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

import run
import tiny
from harness import cell, manifest

ROOT = manifest.ROOT


@pytest.fixture(scope="module")
def results():
    ctx = tiny.speed_ctx()
    return ctx, {t: cell.run(ctx, 11, 0.2, t, torch.device("cpu"), time.perf_counter()) for t in (False, True)}


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(results, trace):
    ctx, res = results
    dev = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    line = run.result_line(ctx, res[trace], trace, dev)
    keys = ["correct", "attempted", "failed", "metrics"] + (["breakdown"] if trace else []) + ["device", "checks"]
    assert list(line) == keys
    json.dumps(line)
    assert set(line["checks"]) == set(ctx.traffic["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    names = {m["name"] for m in (ctx.per_layer if trace else ctx.end_to_end)}
    assert set(line["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"clips_per_s", "setup_s"} <= set(line["metrics"])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", "speed_r50.b8x4x8",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_cannot_build_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['benchmark', '.']\n"
            "from harness import manifest, program\n"
            "ctx = manifest.resolve(manifest.load_manifest(), 'speed_r50.b8x4x8')\n"
            "program.port_config(ctx.spec)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "advise_tpu_torch" in out.stderr
