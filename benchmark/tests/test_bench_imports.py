"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package's, compared as whole names (the
port's own name begins with the JAX package's); and the plain references
import nothing of the measured package."""

import ast
import subprocess
import sys

from harness import manifest

BENCH = manifest.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "advise_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
        assert not _imports(path) & {"chip_smoke", "bench"}, path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "advise_tpu_torch" not in _imports(path), path


def test_a_run_loads_no_forbidden_module():
    code = f"""
import sys, time
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(BENCH.parent)!r}]
import torch, tiny, run, calibrate
from harness import cell
res = cell.run(tiny.speed_ctx(), 5, 0.2, True, torch.device("cpu"), time.perf_counter())
run.result_line(tiny.speed_ctx(), res, True, {{}})
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
