"""Build the port's CUDA sources (``advise_tpu_torch/csrc/*.cu``) with nvcc.

Each source becomes one shared library with a plain C interface, loaded
with ctypes by its kernel module. The library is named by a hash of the
source and its flags and lives in the repo's ignored ``build/`` directory,
so a changed source or flag builds anew and an unchanged one is reused.
Builds happen at first use (or all at once, in parallel, through
:func:`build_all`), never when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# every source of csrc/ with its own flags. fused_aug.cu ends in floor()
# at integer boundaries and states each FMA it wants (__fmaf_rn), so nvcc
# must contract nothing else
SOURCES: Dict[str, Tuple[str, ...]] = {
    "stem_conv.cu": (),
    "fused_aug.cu": ("-fmad=false",),
    "flash_attention.cu": (),
    "flash_attention_f32.cu": (),
    "window_probe.cu": (),
    "batch_norm.cu": (),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: CUDA_HOME's, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")
    return found


def library_path(source: str, extra: Tuple[str, ...] = ()) -> Path:
    """Where ``source``'s library lives: named by the hash of its content
    and flags (``extra``: flags added to its own, such as a -D)."""
    digest = hashlib.sha1((CSRC / source).read_bytes())
    digest.update(" ".join(_COMMON_FLAGS + SOURCES[source] + tuple(extra)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def build_all(sources=None, verbose: bool = False,
              extra: Tuple[str, ...] = ()) -> Dict[str, Tuple[Path, float]]:
    """Compile ``sources`` (default: all of :data:`SOURCES`) that are not
    built yet, one nvcc each with ``extra`` flags, all started together.
    Returns {source: (library path, seconds its build took)}; 0.0 for a
    library that was already there. Raises with nvcc's output if a build
    fails."""
    sources = list(SOURCES if sources is None else sources)
    done = {src: (library_path(src, extra), 0.0) for src in sources
            if library_path(src, extra).exists()}
    todo = [src for src in sources if src not in done]
    if not todo:
        return done
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()

    def compile_one(src: str) -> Tuple[Path, float]:
        out = library_path(src, extra)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_COMMON_FLAGS, *SOURCES[src], *extra, "-o", str(tmp), str(CSRC / src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)  # ptxas -v's report
        os.replace(tmp, out)
        return out, seconds

    with ThreadPoolExecutor(len(todo)) as pool:  # each thread waits on its own nvcc
        done.update(zip(todo, pool.map(compile_one, todo)))
    return done


def ptxas_usage(source: str, extra: Tuple[str, ...] = ()) -> Dict[str, Dict[str, int]]:
    """Per kernel of ``source``'s library (built with ``extra`` flags;
    mangled name): the registers a thread, the bytes of spill stores and
    loads, and the static shared memory, from the ``-Xptxas -v`` report its
    build kept."""
    log = library_path(source, extra).with_suffix(".log")
    usage: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {"registers": 0, "spill_stores": 0, "spill_loads": 0, "smem": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage[name]["spill_stores"], usage[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem"] = int(m.group(1)) if m else 0
    return usage


def load(source: str) -> ctypes.CDLL:
    """The ctypes handle of ``source``'s library, built first if needed."""
    if source not in _loaded:
        (path, _), = build_all([source]).values()
        _loaded[source] = ctypes.CDLL(str(path))
    return _loaded[source]
