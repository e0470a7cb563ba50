"""Where the time of the masked train step goes, on one NVIDIA card, and how
its steps move under config variants.

    python3 -m advise_tpu_torch.tools.profile_masked [--steps N]
    python3 -m advise_tpu_torch.tools.profile_masked --variants "" \\
        MVIT.REV.O1_SCAN=False MVIT.DROPPATH_RATE=0.0 [--steps N]

Both build the path of ``chip_smoke.py`` phase 7 (``MViT_L_32x312_joint.yaml``
at full width and depth: one video x 2 views of uint8 clips, OnlyCrop, the
reversible MViT-L with flash attention, masked MSE + NT-Xent, AdamW) with
the same seeds.

Without ``--variants`` it runs 2 warm-up steps, then ``torch.profiler``
(the device's activity alone, so the host runs at its own pace) over
``--steps`` whole steps with the step's spans recorded
(``utils/host_times.py``): for each span (``step.aug``, ``step.forward``,
``step.backward``, ``step.bn_commit``, ``step.optimizer`` and the root
``step``'s own time) its device busy ms, the idle ms it made the device
wait and its launches a step (``engine/meters.py span_split``); the device
time by kernel (the top 25, and each group's time a step with its share of
the summed kernel time and of the busy time), K4's device time a step by
kernel, and the device busy share of the window (the union of kernel
intervals over the wall time).

With ``--variants`` (each a comma-separated list of KEY=VALUE config
overrides, "" for the preset) it runs ``--steps`` steps of each variant from
the same seeds and prints, per step, loss_mask, the grad norm, the stage
transitions whose drop path zeroed a view, and the peak memory.

No card, no run: it exits non-zero. Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ast
import subprocess
import time

from advise_tpu_torch.engine.meters import busy_ms

CONFIG = "configs/pretrain/MViT_L_32x312_joint.yaml"
# the kernels of csrc/flash_attention.cu, by name in the trace
K4_KERNELS = ("flash_fwd_kernel", "flash_bwd_pre_kernel", "flash_bwd_dkdv_kernel",
              "flash_bwd_reduce_kernel", "flash_bwd_dq_kernel")


def _value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def masked_path(overrides: str, n_steps: int):
    """The masked path of the preset with ``overrides`` ("KEY=VALUE,..."):
    (cfg, model, bundle, state, aug, step, clips, masks, generator, lr)."""
    import numpy as np
    import torch

    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.data import build_device_aug, ingest_geometry
    from advise_tpu_torch.data.masking import build_mask_generator
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.solver.lr_policy import get_lr_at_epoch
    from advise_tpu_torch.solver.optimizer import build_tx

    dev = torch.device("cuda", 0)
    cfg = tconfig.get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    for item in filter(None, overrides.split(",")):
        key, value = item.split("=", 1)
        node = cfg
        *path, leaf = key.strip().split(".")
        for p in path:
            node = node[p]
        node[leaf] = _value(value.strip())
    cfg = tconfig.assert_and_infer_cfg(cfg)
    model = build_model(cfg, dev, seed=0)
    params = dict(model.named_parameters())
    bundle = build_tx(cfg, params)
    state = TrainState(model, bundle.tx.init(params), 0)
    aug = build_device_aug(cfg, "train")
    step = make_train_step(cfg, bundle, aug)
    b, k, t = cfg.DATA.BATCHSIZE_PER_GPU, cfg.DATA.NUM_CLIP, cfg.DATA.NUM_FRAMES
    w, h = ingest_geometry(cfg, "train")
    rng = np.random.default_rng(2)
    clips = torch.from_numpy(rng.integers(0, 256, (b, k, t, h, w, 3), dtype=np.uint8)).to(dev)
    gen = build_mask_generator(cfg)
    grid = (gen.temporal, gen.height, gen.width)
    masks = [torch.from_numpy(np.stack([gen(rng) for _ in range(b * k)])).reshape(b, k, *grid).to(dev)
             for _ in range(n_steps)]
    g = torch.Generator(device=dev).manual_seed(0)
    return cfg, model, bundle, state, aug, step, clips, masks, g, get_lr_at_epoch(cfg, 1.0)


def run_variants(variants, n_steps: int) -> None:
    import torch

    for overrides in variants:
        cfg, model, bundle, state, aug, step, clips, masks, g, lr = masked_path(overrides, n_steps)
        encoder = model.encoder
        transitions = {item[1] for item in encoder.plan if item[0] == "transition"}
        draws = []
        draw = encoder._keeps

        def recording(b, generator):
            keeps = draw(b, generator)
            draws.append({i: [int((~m).sum()) for m in ks if m is not None]
                          for i, ks in keeps.items() if i in transitions})
            return keeps

        encoder._keeps = recording
        torch.cuda.reset_peak_memory_stats()
        for i in range(n_steps):
            stats = step(state, clips, {"mask": masks[i]}, g, lr)
            dropped = {blk: n[0] for blk, n in draws[-1].items() if n and n[0]}
            print(f"[variant {overrides or 'preset'}] step {i}: loss_mask {float(stats['loss_mask'])} "
                  f"grad_norm {float(stats['grad_norm'])} views zeroed at transitions {dropped} "
                  f"peak {torch.cuda.max_memory_allocated()} bytes")
        del model, bundle, state, step
        torch.cuda.empty_cache()


def profile(n_steps: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from advise_tpu_torch.engine.meters import device_ops, launch_times, span_split
    from advise_tpu_torch.utils.host_times import HOST_TIMES

    cfg, model, bundle, state, aug, step, clips, masks, g, lr = masked_path("", 2 + n_steps)
    for i in range(2):
        step(state, clips, {"mask": masks[i]}, g, lr)
    torch.cuda.synchronize()

    HOST_TIMES.start()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(state, clips, {"mask": masks[2 + i]}, g, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = HOST_TIMES.stop()
    kernels = device_ops(prof)
    busy = busy_ms((start / 1e3, (start + dur) / 1e3) for _, start, dur, _ in kernels)
    by_name = {}
    for name, _, dur, _ in kernels:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    device_ms = sum(by_name.values())
    print(f"[profile] {n_steps} steps: wall {wall_ms} ms, kernels {len(kernels)}, device busy "
          f"{busy} ms ({100 * busy / wall_ms} % of the wall; idle {100 - 100 * busy / wall_ms} %), "
          f"summed kernel time {device_ms} ms (overlapping kernels count each)")
    split = span_split(spans, kernels, launch_times(prof))
    for name, row in sorted(split.items(), key=lambda kv: -kv[1]["busy_ms"]):
        print(f"[span] {name}: device busy {row['busy_ms'] / n_steps} ms, waited {row['waited_ms'] / n_steps} "
              f"ms, {row['launches'] / n_steps} launches a step")
    groups = {"flash attention (K4)": K4_KERNELS, "GEMMs": ("gemm", "Gemm", "cutlass", "sm90_xmma"),
              "convolutions": ("conv", "Conv", "implicit"), "elementwise": ("elementwise", "Elementwise"),
              "reductions": ("reduce", "Reduce"), "layer norm": ("layer_norm", "LayerNorm")}
    for gname, keys in groups.items():
        ms = sum(v for kname, v in by_name.items() if any(key in kname for key in keys))
        # a group's kernels may overlap other work, so its share of the busy
        # time is an upper bound on what removing it would save
        print(f"[profile] {gname}: {ms} ms, {ms / n_steps} ms a step ({100 * ms / device_ms} % of "
              f"summed kernel time, {100 * ms / busy} % of busy time)")
    k4 = {kname: v for kname, v in by_name.items() if any(key in kname for key in K4_KERNELS)}
    for kname, ms in sorted(k4.items(), key=lambda kv: -kv[1]):
        print(f"[profile] K4 {ms / n_steps:10.3f} ms a step  {kname[:110]}")
    print(f"[profile] K4 device time a step: {sum(k4.values()) / n_steps} ms ({len(k4)} kernels)")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"[profile] {ms:10.3f} ms {100 * ms / device_ms:6.2f} %  {kname[:110]}")


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--variants", nargs="*", default=None,
                        help='config overrides "KEY=VALUE,...", one argument a variant ("" = preset)')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_masked: no CUDA card; the measurement runs on a card only")
    from advise_tpu_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[env] card: {card}, torch {torch.__version__}")
    build.build_all()
    if args.variants is not None:
        run_variants(args.variants, args.steps)
    else:
        profile(args.steps)
    print(card)


if __name__ == "__main__":
    main()
