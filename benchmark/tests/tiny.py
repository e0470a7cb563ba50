"""A tiny copy of the speed cell for the CPU tests: Slow-R10 at 32^2 on 4
videos x 2 clips x 4 frames, the program in float32, so that program and
reference agree to rounding."""

from __future__ import annotations

import copy
import sys
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest  # noqa: E402


def speed_ctx(dtype: str = "float32", limits=None) -> SimpleNamespace:
    ctx = manifest.resolve(manifest.load_manifest(ROOT), "speed_r50.b8x4x8", ROOT)
    spec, traffic = copy.deepcopy(ctx.spec), copy.deepcopy(ctx.traffic)
    spec["preset"]["RESNET"].update(DEPTH=10, NUM_BLOCK_TEMP_KERNEL=[[1], [1], [1], [1]])
    spec["preset"]["SSL"]["MLP_DIM"] = 64
    spec["preset"]["DATA"].update(BATCHSIZE_PER_GPU=4, NUM_CLIP=2, NUM_FRAMES=4)
    spec["preset"]["AUG"].update(RESIZE=[48, 40], TARGET_SIZE=32)
    spec["preset"]["TPU"]["COMPUTE_DTYPE"] = dtype
    rs = spec["reference_spec"]
    rs.update(stage_blocks=[1, 1, 1, 1], num_block_temp_kernel=[1, 1, 1, 1], mlp_dim=64)
    rs["aug"]["crop"] = 32
    traffic.update(videos_per_step=4, clips_per_video=2, frames=4, ingest=[40, 48], trace_steps=2, lr=1e-3)
    traffic["limits"] = limits or {"grad1": 1e-3, "change": 5e-3}
    ctx.spec, ctx.traffic = spec, traffic
    return ctx
