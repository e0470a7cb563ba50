"""Step times of the port's presets in this tree and, with ``--parent``, in
another checkout of the repo, in turns, on one NVIDIA card:

    python3 -m advise_tpu_torch.tools.compare_steps [--parent DIR]

PRESETS: the train steps of BYOL (SlowFast-R50), speed (Slow-R50), masked
(MViT-L) and AdViSe, and action_infer's batch (the linear probe's
Slow-R50 on one video's 10 clips x 3 crops). Each tree runs in a process
of its own (with ``--parent``: parent, this tree, this tree, parent), so
that a change is read against its parent on the same card and host rather
than against another machine's numbers. Both trees run this file's
:func:`step_run` and :func:`time_steps`, which use only entry points the
trees share, on their own package. A run builds each preset on the card
(one card: NUM_GPUS, TPU.MESH_SYNC and BN.NUM_SYNC_DEVICES 1; weights from
TRAIN.SEED), feeds uint8 clips at the preset's ingest geometry, and prints
the median of STEPS timed steps after WARMUP, host clock around a step
that ends in a synchronize. No card, no run: it exits non-zero. Prints the
card's name and power limit.

``chip_smoke.py`` times its X3D, MoCo and AdViSe steps with the same two
functions.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

PRESETS = {"byol": "configs/pretrain/SlowFast_R50_K400.yaml",
           "speed": "configs/pretrain/SpeedPro_R50.yaml",
           "masked": "configs/pretrain/MViT_L_32x312_joint.yaml",
           "advise": "configs/pretrain/AdViSe.yaml",
           "action_infer": "configs/eval/linear_probe_ucf.yaml"}
WARMUP, STEPS = 2, 5
EPOCH = 1.0  # inside every preset's warm-up


def step_run(cfg, dev, seed: int, epoch: float) -> SimpleNamespace:
    """What a timed train step of ``cfg`` needs on ``dev``: the state and
    step of ``build_train_state`` and ``make_train_step`` (``aug`` the
    train aug), uint8 clips [B, K, T, H, W, 3] at the config's ingest
    geometry and ``infos`` from numpy's ``seed`` (item ids for
    ContrastiveModel, a block mask a clip for MaskMViT on loader masks,
    none for its in-model masks, else speed labels),
    the aug's generator and the lr of the port's policy at ``epoch``.
    ``run.call(infos=None)`` takes one step and returns its stats."""
    import numpy as np
    import torch

    from advise_tpu_torch.data import build_device_aug, ingest_geometry
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.engine.train import build_train_state
    from advise_tpu_torch.solver.lr_policy import get_lr_at_epoch

    state, bundle = build_train_state(cfg, dev)
    aug = build_device_aug(cfg, "train")
    step = make_train_step(cfg, bundle, aug)
    b, k, t = cfg.DATA.BATCHSIZE_PER_GPU, cfg.DATA.NUM_CLIP, cfg.DATA.NUM_FRAMES
    w_in, h_in = ingest_geometry(cfg, "train")
    rng = np.random.default_rng(seed)
    clips = torch.from_numpy(rng.integers(0, 256, size=(b, k, t, h_in, w_in, 3), dtype=np.uint8)).to(dev)
    extra = ()
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        infos = {"item_id": torch.arange(b, device=dev)}
        extra = (epoch,)
    elif cfg.MODEL.MODEL_NAME == "MaskMViT" and cfg.MASK.MAE_RND_MASK:
        infos = {}  # the model draws its masks from the step's generator
    elif cfg.MODEL.MODEL_NAME == "MaskMViT":
        from advise_tpu_torch.data.masking import build_mask_generator

        mask_gen = build_mask_generator(cfg)
        masks = np.stack([mask_gen(rng) for _ in range(b * k)])
        infos = {"mask": torch.from_numpy(masks).reshape(b, k, *masks.shape[1:]).to(dev)}
    else:
        infos = {"spd_label": torch.from_numpy(rng.integers(0, cfg.MODEL.NUM_CLASSES, (b, k))).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    lr = get_lr_at_epoch(cfg, epoch)
    run = SimpleNamespace(state=state, bundle=bundle, aug=aug, step=step, clips=clips, infos=infos, gen=gen,
                          lr=lr)
    run.call = lambda infos=None: step(state, clips, run.infos if infos is None else infos, gen, lr, *extra)
    return run


def time_steps(run, warmup: int, timed: int, counters=(), infos_fn=None, after_step=None):
    """``warmup + timed`` calls of ``run.call`` (a :func:`step_run`, or any
    object whose ``call(infos)`` returns a dict of scalar tensors), host
    clock around a call that ends in a synchronize on a card. The peak
    memory and each of ``counters``' ``launches`` are reset first.
    ``infos_fn(i)`` gives step i's infos (the run's own when None);
    ``after_step(i, stats, ms)`` sees each step's stats as floats. Returns
    (median ms of the timed calls, every call's ms, peak allocated bytes
    on a card or None, launches by counter name)."""
    import torch

    on_card = torch.cuda.is_available() and run.clips.is_cuda
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    step_ms = []
    for i in range(warmup + timed):
        infos = None if infos_fn is None else infos_fn(i)
        t0 = time.perf_counter()
        stats = run.call(infos)
        vals = {name: float(v) for name, v in stats.items()}
        if on_card:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if after_step is not None:
            after_step(i, vals, step_ms[-1])
    peak = torch.cuda.max_memory_allocated() if on_card else None
    launches = {fn.__name__: fn.launches for fn in counters}
    return statistics.median(step_ms[warmup:]), step_ms, peak, launches


def infer_run(cfg, dev, seed: int) -> SimpleNamespace:
    """action_infer's batch as ``engine/inference.py`` runs it: the views of
    INFER.BATCHSIZE_PER_GPU videos (numpy uint8 at the 'action' ingest
    geometry, from ``seed``) stacked, put on ``dev``, through the eval step
    with INFER.SEED's crops, the views' logits averaged and the argmax
    brought to the host. ``run.call()`` runs one batch and returns the
    first video's prediction; weights from TRAIN.SEED."""
    import numpy as np
    import torch

    from advise_tpu_torch.data import build_device_aug, device_put_batch, ingest_geometry
    from advise_tpu_torch.engine.steps import make_eval_step
    from advise_tpu_torch.engine.train import seeded_generator
    from advise_tpu_torch.models import build_model

    model = build_model(cfg, dev, seed=cfg.TRAIN.SEED)
    eval_step = make_eval_step(cfg, build_device_aug(cfg, "action"))
    views = cfg.INFER.NUM_CLIPS * cfg.INFER.NUM_CROPS
    vids = max(cfg.INFER.BATCHSIZE_PER_GPU, 1)
    w, h = ingest_geometry(cfg, "action")
    rng = np.random.default_rng(seed)
    videos = [rng.integers(0, 256, (views, cfg.INFER.NUM_FRAMES, h, w, 3), dtype=np.uint8) for _ in range(vids)]

    def call(infos=None):
        clips = np.stack(videos)
        batch, _, _ = device_put_batch(clips.reshape(vids * views, 1, *clips.shape[2:]), {}, dev)
        logits = eval_step(model, batch, seeded_generator(dev, cfg.INFER.SEED, 0))
        preds = torch.argmax(logits.reshape(vids, views, -1).float().mean(dim=1), dim=-1).cpu()
        return {"pred0": preds[0]}

    return SimpleNamespace(model=model, clips=torch.empty(0, device=dev), call=call)


def one_card(path: str):
    """The config at ``path`` on one card: NUM_GPUS, TPU.MESH_SYNC and
    BN.NUM_SYNC_DEVICES 1."""
    from advise_tpu_torch import config as tconfig

    cfg = tconfig.get_cfg()
    cfg.merge_from_file(path)
    cfg.NUM_GPUS = cfg.NUM_WORLDS = cfg.TPU.MESH_SYNC = cfg.BN.NUM_SYNC_DEVICES = 1
    return tconfig.assert_and_infer_cfg(cfg)


def run_presets() -> dict:
    """Every preset in this process, on the package the import path finds:
    {name: {"median_ms", "all_ms"}}."""
    import torch

    dev = torch.device("cuda", 0)
    out = {}
    for name, path in PRESETS.items():
        cfg = one_card(path)
        run = infer_run(cfg, dev, 0) if name == "action_infer" else step_run(cfg, dev, 0, EPOCH)
        median_ms, all_ms, _, _ = time_steps(run, WARMUP, STEPS)
        out[name] = {"median_ms": median_ms, "all_ms": all_ms}
        if name == "action_infer":
            out[name]["views"] = cfg.INFER.NUM_CLIPS * cfg.INFER.NUM_CROPS * max(cfg.INFER.BATCHSIZE_PER_GPU, 1)
        del run
        gc.collect()  # run.call holds the run
        torch.cuda.empty_cache()
    return out


def run_tree(root: Path) -> dict:
    """:func:`run_presets` in a process whose package is ``root``'s."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree"], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"compare_steps: the run in {root} exited with {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None, help="the root of another checkout")
    ap.add_argument("--tree", action="store_true", help=argparse.SUPPRESS)  # one tree, in this process
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_steps: torch.cuda.is_available() is False; it runs on a card only")
    if args.tree:
        print(json.dumps(run_presets()))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    here = Path(__file__).resolve().parents[2]
    order = [("this", here), ("this", here)]
    if args.parent is not None:
        order = [("parent", args.parent.resolve())] + order + [("parent", args.parent.resolve())]
    for label, root in order:
        for name, res in run_tree(root).items():
            rate = f", {res['views'] * 1e3 / res['median_ms']} views/s" if "views" in res else ""
            print(f"[steps] {label} {name} ({PRESETS[name]}): median {res['median_ms']} ms{rate} "
                  f"(all {res['all_ms']})")
    print(card)


if __name__ == "__main__":
    main()
