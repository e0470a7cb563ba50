"""Drive the PyTorch port (advise_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA and
   nvcc versions. No card, no run: there is no CPU fallback;
2. build: every kernel source of advise_tpu_torch/csrc/ (the stem conv and
   the fused simple aug), one nvcc each, started together, each timed;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   same inputs (TF32 off): the stem kernels at the BYOL path's stem shape
   and a ragged small shape, the fused aug at SpeedPro's shape (float32 and
   bf16 outputs, the preset's colour probability and p = 1) and a ragged
   one. Times are CUDA events, median of 20 in the order plain, kernel,
   kernel, plain; beside them the least time the card could take (bytes or
   operations over the card's peak rates) and, where one PyTorch call
   computes the same function, that call's time;
4. small input: each full-width model's forward on the card (bf16) against
   the same weights' float32 forward on the CPU: SlowFast-R50 BYOL and the
   Slow-R50 speed model;
5. the BYOL path: the SlowFast-R50 BYOL pretrain step of
   configs/pretrain/SlowFast_R50_K400.yaml at full width on one card, uint8
   clips through the 'aa' augmentation, 2 warm-up and 5 timed steps;
6. the speed path: the Slow-R50 speed-pretext step of
   configs/pretrain/SpeedPro_R50.yaml at full width on one card, uint8 clips
   through the 'simple' augmentation (the fused aug kernel), the lr from the
   port's lr policy, 2 warm-up and 5 timed steps.

Each path's kernel launch counts are reset just before its steps and read
just after. The line before the last is nvidia-smi's name and power limit;
the last is {"ok": true, "device": {...}}.
"""

import json
import math
import statistics
import subprocess
import sys
import time

BYOL_CONFIG = "configs/pretrain/SlowFast_R50_K400.yaml"
SPEED_CONFIG = "configs/pretrain/SpeedPro_R50.yaml"
WARMUP_STEPS, TIMED_STEPS = 2, 5
LR, EPOCH_EXACT = 1e-3, 1.0
SPEED_EPOCH = 1.0  # inside SpeedPro's 10 warm-up epochs
SLOW_R50_SPEED_PARAMS = 40_047_684  # the JAX package's oracle (tests/test_models.py)

# H100 SXM (NVIDIA's data sheet): device memory rate, dense bf16 tensor
# cores, float32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
# float operations of the fused aug per output element: the luma (5), the
# three blends (5 each) and the normalisation lookup, rounded up
AUG_OPS_PER_ELEMENT = 25


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def one_card_cfg(tconfig, path):
    cfg = tconfig.get_cfg()
    cfg.merge_from_file(path)
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    return tconfig.assert_and_infer_cfg(cfg)


def bound(nbytes: float, ops: float, kind: str):
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; the port runs on a card only")

    import numpy as np

    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.data import build_device_aug, ingest_geometry
    from advise_tpu_torch.engine.contrastive import init_ssl_state
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.ops import build
    from advise_tpu_torch.ops import fused_aug as fa
    from advise_tpu_torch.ops import stem_conv as sc
    from advise_tpu_torch.solver.lr_policy import get_lr_at_epoch
    from advise_tpu_torch.solver.optimizer import build_tx

    dev = torch.device("cuda", 0)
    # the plain versions are the references: no TF32 anywhere in this run
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. environment ---------------------------------------------------------
    card = card_line()
    nvcc_version = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, {nvcc_version}, "
          f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all(verbose=True)
    for src, (path, seconds) in built.items():
        print(f"[build] {src} -> {path.name} in {seconds:.3f} s")
    print(f"[build] all sources in {time.perf_counter() - t0:.3f} s (in parallel)")

    # -- 3. kernel vs plain -----------------------------------------------------
    cfg = one_card_cfg(tconfig, BYOL_CONFIG)
    b, k, t = cfg.DATA.BATCHSIZE_PER_GPU, cfg.DATA.NUM_CLIP, cfg.DATA.NUM_FRAMES
    s = cfg.AUG.TARGET_SIZE
    kt = 5  # the fast stem's temporal kernel (SLOWFAST_TEMP_KERNELS)
    g = torch.Generator(device=dev).manual_seed(0)

    def times_ms(fn, n=10):
        out = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def in_turns(kernel, plain):
        kernel()  # warm both
        plain()
        torch.cuda.synchronize()
        p, kk = times_ms(plain), times_ms(kernel)
        kk += times_ms(kernel)
        p += times_ms(plain)
        return statistics.median(kk), statistics.median(p)

    def alone(fn):
        fn()
        torch.cuda.synchronize()
        return statistics.median(times_ms(fn, 20))

    results = {}
    # the BYOL path runs both views as one batch: the stem sees k * b clips
    for shape in [(k * b, t, s, s, 3), (2, 7, 37, 45, 3)]:
        x = torch.randn(shape, device=dev, generator=g).bfloat16()
        w = (torch.randn((kt, 7, 7, 3, 8), device=dev, generator=g) * 0.1).bfloat16()
        y = sc.stem_conv_fwd(x, w)
        ref = sc.stem_conv_plain(x.float(), w.float())
        torch.cuda.synchronize()
        fwd_err = float((y.float() - ref).abs().max())
        top = float(ref.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)  # one bf16 ulp of the largest output
        print(f"[kernel] stem_conv_fwd {shape}: max_abs_err {fwd_err} (bound: one bf16 ulp "
              f"of max|y| {top} = {ulp})")
        check(math.isfinite(fwd_err) and fwd_err <= ulp, f"stem_conv_fwd disagrees at {shape}")

        gy = torch.randn(y.shape, device=dev, generator=g).bfloat16()
        del ref
        dw = sc.stem_conv_wgrad(x, gy, kt)
        dref = sc.stem_wgrad_plain(x, gy, kt)
        torch.cuda.synchronize()
        wg_err = float((dw - dref).abs().max())
        wg_top = float(dref.abs().max())
        print(f"[kernel] stem_conv_wgrad {shape}: max_abs_err {wg_err} "
              f"(bound: 1e-3 * max|dW| {wg_top} = {1e-3 * wg_top})")
        check(math.isfinite(wg_err) and wg_err <= 1e-3 * wg_top,
              f"stem_conv_wgrad disagrees at {shape}")
        check(torch.equal(dw, sc.stem_conv_wgrad(x, gy, kt)), "stem_conv_wgrad is not deterministic")
        if shape[0] == k * b:
            fwd_ms, fwd_plain_ms = in_turns(lambda: sc.stem_conv_fwd(x, w),
                                            lambda: sc.stem_conv_plain(x, w))
            wg_ms, wg_plain_ms = in_turns(lambda: sc.stem_conv_wgrad(x, gy, kt),
                                          lambda: sc.stem_wgrad_plain(x, gy, kt))
            # the library call for the weight gradient in the kernel's input
            # type: cuDNN's bf16 conv3d_weight (bf16 out); for the forward it
            # is the plain version itself, cuDNN's bf16 conv3d
            x_ncdhw, g_ncdhw = x.permute(0, 4, 1, 2, 3), gy.permute(0, 4, 1, 2, 3)
            wg_lib_ms = alone(lambda: torch.nn.grad.conv3d_weight(
                x_ncdhw, (8, 3, kt, 7, 7), g_ncdhw, stride=(1, 2, 2), padding=(kt // 2, 3, 3)))
            flops = 2.0 * kt * 7 * 7 * 3 * 8 * y.numel() / 8
            fwd_bound = bound(2.0 * (x.numel() + w.numel() + y.numel()), flops, "bf16")
            wg_bound = bound(2.0 * (x.numel() + gy.numel()) + 4.0 * dw.numel(), flops, "bf16")
            print(f"[kernel] stem_conv_fwd {shape}: {fwd_ms} ms, plain (cuDNN bf16 conv3d) "
                  f"{fwd_plain_ms} ms, bound {fwd_bound[0]} ms ({fwd_bound[1]})")
            print(f"[kernel] stem_conv_wgrad {shape}: {wg_ms} ms, plain (cuDNN f32 "
                  f"conv3d_weight) {wg_plain_ms} ms, library (cuDNN bf16 conv3d_weight) "
                  f"{wg_lib_ms} ms, bound {wg_bound[0]} ms ({wg_bound[1]})")
            results["stem_conv_fwd"] = dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                                            library_ms=fwd_plain_ms, bound=fwd_bound)
            results["stem_conv_wgrad"] = dict(max_abs_err=wg_err, ms=wg_ms, plain_ms=wg_plain_ms,
                                              library_ms=wg_lib_ms, bound=wg_bound)
            del x_ncdhw, g_ncdhw
        del x, y, gy, dw, dref
    torch.cuda.empty_cache()

    scfg = one_card_cfg(tconfig, SPEED_CONFIG)
    sb, sk, st = scfg.DATA.BATCHSIZE_PER_GPU, scfg.DATA.NUM_CLIP, scfg.DATA.NUM_FRAMES
    ss = int(scfg.AUG.TARGET_SIZE)
    sw_in, sh_in = ingest_geometry(scfg, "train")
    mean, std = tuple(scfg.DATA.MEAN), tuple(scfg.DATA.STD)
    preset_color = tuple(scfg.AUG.COLOR)
    aug_err = 0.0
    # the speed path runs its b * k clips as one batch through the aug; the
    # ragged case: W*3 = 129, an odd crop, tops that are not 8-aligned
    for shape, size, colors in [((sb * sk, st, sh_in, sw_in, 3), ss, (preset_color, (1.0,) + preset_color[1:])),
                                ((3, 5, 41, 43, 3), 29, ((1.0, 0.4, 0.4, 0.4, 0.2),))]:
        clips = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
        clips[:, 0, :, : shape[3] // 3] = clips[:, 0, :, : shape[3] // 3, :1]  # gray pixels
        for color in colors:
            prm = fa.sample_simple_aug(shape[0], shape[2], shape[3], size, color, g)
            if size == 29:
                prm["tops"] = torch.tensor([3, 9, 11], dtype=torch.int32, device=dev)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = fa.fused_simple_aug(clips, prm, size, mean, std, out_dtype)
                want = fa.fused_simple_aug_plain(clips, prm, size, mean, std, out_dtype)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                aug_err = max(aug_err, err)
                print(f"[kernel] fused_simple_aug {shape} crop {size} p {color[0]} {out_dtype}: "
                      f"max_abs_err {err} (bound: 0, exact), equal {torch.equal(got, want)}")
                check(torch.equal(got, want), f"fused_simple_aug disagrees at {shape} {out_dtype}")
                if shape[0] == sb * sk and color == preset_color:
                    aug_ms, aug_plain_ms = in_turns(
                        lambda: fa.fused_simple_aug(clips, prm, size, mean, std, out_dtype),
                        lambda: fa.fused_simple_aug_plain(clips, prm, size, mean, std, out_dtype))
                    n_out = got.numel()
                    applied = float(prm["apply"].float().mean())
                    aug_bound = bound(n_out + 7 * 4 * shape[0] + n_out * got.element_size(),
                                      AUG_OPS_PER_ELEMENT * n_out * applied + 2 * n_out, "f32")
                    print(f"[kernel] fused_simple_aug {shape} crop {size} {out_dtype}: {aug_ms} ms, "
                          f"plain {aug_plain_ms} ms, bound {aug_bound[0]} ms ({aug_bound[1]}), "
                          f"no single library call")
                    if out_dtype == torch.float32:  # the speed path's output type (AUG_COMPUTE_OUT off)
                        results["fused_simple_aug"] = dict(ms=aug_ms, plain_ms=aug_plain_ms,
                                                           library_ms=None, bound=aug_bound)
                del got, want
        del clips
    results["fused_simple_aug"]["max_abs_err"] = aug_err
    torch.cuda.empty_cache()

    # -- 4. small input: the card's bf16 forward against a CPU float32 one --------
    small = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, t, 64, 64, 3)).astype(np.float32))
    for name, mcfg, width in (("SlowFast-R50 BYOL", cfg, cfg.CONTRASTIVE.DIM),
                              ("Slow-R50 speed", scfg, scfg.MODEL.NUM_CLASSES)):
        ref_cfg = mcfg.clone()
        ref_cfg.TPU.COMPUTE_DTYPE = "float32"
        ref_model = build_model(ref_cfg, "cpu", seed=0).eval()
        card_model = build_model(mcfg, dev, seed=0).eval()
        x_small = small[:, : mcfg.DATA.NUM_FRAMES]
        with torch.no_grad():
            want = ref_model(x_small)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                got = card_model(x_small.to(dev).bfloat16())
        outs = zip(("projection", "prediction"), got, want) if isinstance(got, list) else [("logits", got, want)]
        for out_name, a, r in outs:
            check(tuple(a.shape) == (2, width), f"{name} {out_name} has shape {tuple(a.shape)}")
            rel = float((a.float().cpu() - r).abs().max() / r.abs().max())
            # bf16 activations round at 2^-8 through ~50 layers: ~1e-2 (7.8e-3
            # for a CPU bf16 run of the SlowFast check); a wrong layer is O(1)
            print(f"[small] {name} {out_name}: max rel err vs CPU float32 {rel} (bound 5e-2)")
            check(math.isfinite(rel) and rel <= 5e-2, f"the card's {name} {out_name} disagrees with the CPU")
        del ref_model, card_model, got, want
    torch.cuda.empty_cache()

    # -- 5. the BYOL path ---------------------------------------------------------
    model = build_model(cfg, dev, seed=0)
    params = dict(model.named_parameters())
    bundle = build_tx(cfg, params)
    ssl = init_ssl_state(cfg, model, torch.Generator(device=dev).manual_seed(7))
    state = TrainState(model, bundle.tx.init(params), 0, ssl)
    step = make_train_step(cfg, bundle, build_device_aug(cfg, "train"))
    w_in, h_in = ingest_geometry(cfg, "train")
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(
        rng.integers(0, 256, size=(b, k, t, h_in, w_in, 3), dtype=np.uint8)).to(dev)
    infos = {"item_id": torch.from_numpy(rng.integers(0, cfg.CONTRASTIVE.LENGTH, (b,))).to(dev)}
    aug_gen = torch.Generator(device=dev).manual_seed(0)
    n_params = sum(p.numel() for p in params.values())
    print(f"[byol] SlowFast-R{cfg.RESNET.DEPTH} BYOL, {n_params} params, clips "
          f"{tuple(clips.shape)} uint8, {cfg.TPU.COMPUTE_DTYPE}, REMAT {cfg.TPU.REMAT}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.stem_conv_fwd.launches = 0
    sc.stem_conv_wgrad.launches = 0
    fa.fused_simple_aug.launches = 0
    step_ms = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        stats = step(state, clips, infos, aug_gen, LR, EPOCH_EXACT)
        loss, gnorm = float(stats["loss_byol"]), float(stats["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[byol] step {i}: loss {loss} grad_norm {gnorm} ({step_ms[-1]} ms)")
        check(math.isfinite(loss) and math.isfinite(gnorm), f"step {i} is not finite")
    launches = {"stem_conv_fwd": sc.stem_conv_fwd.launches,
                "stem_conv_wgrad": sc.stem_conv_wgrad.launches}
    peak = torch.cuda.max_memory_allocated()

    check(state.step == WARMUP_STEPS + TIMED_STEPS, "the state did not advance")
    for name, tensors in (("params", model.parameters()),
                          ("momentum encoder", state.ssl["ema_model"].parameters()),
                          ("kNN bank", [state.ssl["knn_mem"]])):
        check(all(bool(torch.isfinite(p).all()) for p in tensors), f"{name} not finite")
    median_ms = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[byol] median step {median_ms} ms over {TIMED_STEPS} steps, "
          f"{k * b * 1e3 / median_ms} clip-views/s ({b} clips x {k} views), "
          f"peak allocated {peak} bytes")
    print(f"[byol] launches during the steps: {launches}, fused_simple_aug "
          f"{fa.fused_simple_aug.launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the BYOL path")
    del model, params, bundle, ssl, state, step, clips, stats
    torch.cuda.empty_cache()

    # -- 6. the speed path --------------------------------------------------------
    model = build_model(scfg, dev, seed=0)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    check(n_params == SLOW_R50_SPEED_PARAMS, f"Slow-R50 speed model has {n_params} params")
    bundle = build_tx(scfg, params)
    state = TrainState(model, bundle.tx.init(params), 0)
    step = make_train_step(scfg, bundle, build_device_aug(scfg, "train"))
    rng = np.random.default_rng(1)
    clips = torch.from_numpy(
        rng.integers(0, 256, size=(sb, sk, st, sh_in, sw_in, 3), dtype=np.uint8)).to(dev)
    # speed labels from a seed (SpeedClipSampler belongs to the loader slice)
    infos = {"spd_label": torch.from_numpy(
        rng.integers(0, scfg.MODEL.NUM_CLASSES, (sb, sk))).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    lr = get_lr_at_epoch(scfg, SPEED_EPOCH)
    print(f"[speed] Slow-R{scfg.RESNET.DEPTH} speed, {n_params} params, clips "
          f"{tuple(clips.shape)} uint8 -> crop {ss}, {scfg.TPU.COMPUTE_DTYPE}, REMAT "
          f"{scfg.TPU.REMAT}, dropout {scfg.MODEL.DROPOUT_RATE}, lr {lr} at epoch {SPEED_EPOCH}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.stem_conv_fwd.launches = 0
    sc.stem_conv_wgrad.launches = 0
    fa.fused_simple_aug.launches = 0
    step_ms = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        stats = step(state, clips, infos, gen, lr)
        vals = {name: float(v) for name, v in stats.items()}
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[speed] step {i}: loss_spd {vals['loss_spd']} acc_spd {vals['acc_spd']} "
              f"grad_norm {vals['grad_norm']} ({step_ms[-1]} ms)")
        check(all(math.isfinite(v) for v in vals.values()), f"speed step {i} is not finite")
    launches["fused_simple_aug"] = fa.fused_simple_aug.launches
    speed_stem = (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches)
    peak = torch.cuda.max_memory_allocated()
    check(state.step == WARMUP_STEPS + TIMED_STEPS, "the speed state did not advance")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "speed params not finite")
    median_ms = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[speed] median step {median_ms} ms over {TIMED_STEPS} steps, "
          f"{sb * sk * 1e3 / median_ms} clips/s ({sb} videos x {sk} clips), "
          f"peak allocated {peak} bytes")
    print(f"[speed] launches during the steps: fused_simple_aug {launches['fused_simple_aug']}, "
          f"stem kernels {speed_stem} (the slow stem is a plain conv)")
    check(launches["fused_simple_aug"] == WARMUP_STEPS + TIMED_STEPS,
          "fused_simple_aug was not launched once per speed step")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound"][0], "bound_by": results[name]["bound"][1],
         "library_ms": results[name]["library_ms"]}
        for name, source, replaces in (
            ("stem_conv_fwd", "advise_tpu_torch/csrc/stem_conv.cu",
             "advise_tpu/ops/pallas/stem_conv.py:99"),
            ("stem_conv_wgrad", "advise_tpu_torch/csrc/stem_conv.cu",
             "advise_tpu/ops/pallas/stem_conv.py:126"),
            ("fused_simple_aug", "advise_tpu_torch/csrc/fused_aug.cu",
             "advise_tpu/ops/pallas/fused_aug.py:57"))
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
