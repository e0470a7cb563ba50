"""The attention core's spans and counters (``models/layers/attention.py``):
on a tiny MViTv2 masked step on the CPU (relative position biases, residual
pooling, a cls token, DIM_MUL_IN_ATT, one Q-pool transition, loader masks,
HOG, AdamW, REMAT), each route's span opens in the forward pass, in REMAT's
recomputation and in the core's backward; the calls per step by route
equal the blocks; two steps come out bit-equal with the spans recorded
and under a profiler as without; the relative position indices are made
on the host once."""

import numpy as np
import pytest
import torch

from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data.masking import build_mask_generator
from advise_tpu_torch.engine.steps import make_train_step
from advise_tpu_torch.engine.train import build_train_state
from advise_tpu_torch.models.layers.attention import ATTENTION_CALLS
from advise_tpu_torch.utils.host_times import HOST_TIMES

DEPTH = 3
ROUTES = ("attn.k4", "attn.relpos", "attn.dense")
# route -> the overrides that send every block there
ROUTE_KEYS = {
    "attn.relpos": {},
    "attn.k4": {"MVIT.REL_POS_SPATIAL": False, "MVIT.REL_POS_TEMPORAL": False},
    "attn.dense": {"MVIT.REL_POS_SPATIAL": False, "MVIT.REL_POS_TEMPORAL": False,
                   "TPU.FLASH_ATTENTION": False},
}


def tiny_cfg(remat=True, **overrides):
    """configs/pretrain/MaskFeat_MViTv2_L_16x224.yaml at 3 blocks of width 16
    (32 after the transition at block 1), 2 clips of 4 frames at 32^2,
    float32."""
    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/pretrain/MaskFeat_MViTv2_L_16x224.yaml")
    cfg.NUM_GPUS = 1
    cfg.NUM_WORLDS = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.REMAT = remat
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.NUM_HEADS = 1
    cfg.MVIT.DEPTH = DEPTH
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [2, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1]]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    cfg.MASK.PRETRAIN_DEPTH = [DEPTH - 1]
    cfg.MASK.PRED_HOG_CELL_SZ = 4
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.BATCHSIZE_PER_GPU = 2
    for size in ("DATA.TRAIN_CROP_SIZE", "DATA.TEST_CROP_SIZE", "AUG.TARGET_SIZE"):
        cfg.merge_from_list([size, 32])
    for key, value in overrides.items():
        cfg.merge_from_list([key, value])
    return tconfig.assert_and_infer_cfg(cfg)


def batches(cfg, n):
    """n (clips_u8 [B, 1, T, 32, 43, 3], infos with the loader's masks)."""
    g = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    masks = build_mask_generator(cfg)
    b = cfg.DATA.BATCHSIZE_PER_GPU
    out = []
    for _ in range(n):
        clips = torch.randint(0, 256, (b, 1, cfg.DATA.NUM_FRAMES, 32, 43, 3), generator=g, dtype=torch.uint8)
        mask = torch.from_numpy(np.stack([masks(rng) for _ in range(b)]))[:, None]
        out.append((clips, {"mask": mask}))
    return out


def run_steps(cfg, data, record=False, profile=False):
    """The steps from TRAIN.SEED's weights; returns the parameters after,
    each step's calls by route, and the spans recorded."""
    from advise_tpu_torch.data import build_device_aug

    torch.manual_seed(0)
    state, bundle = build_train_state(cfg, "cpu")
    step = make_train_step(cfg, bundle, build_device_aug(cfg, "train"))
    calls, spans = [], []
    if record:
        HOST_TIMES.start()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if profile else None
    if prof is not None:
        prof.__enter__()
    try:
        for i, (clips, infos) in enumerate(data):
            before = dict(ATTENTION_CALLS)
            step(state, clips, infos, torch.Generator().manual_seed(100 + i), 1e-3)
            calls.append({k: n - before.get(k, 0) for k, n in ATTENTION_CALLS.items() if n != before.get(k, 0)})
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if record:
            spans = HOST_TIMES.stop()
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    names = [e.name for e in prof.events()] if prof is not None else []
    return params, calls, spans, names


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("route", sorted(ROUTE_KEYS))
def test_each_route_spans_forward_recompute_and_backward(route, remat):
    cfg = tiny_cfg(remat, **ROUTE_KEYS[route])
    _, calls, spans, _ = run_steps(cfg, batches(cfg, 1), record=True)
    by_index = dict(enumerate(spans))

    def inside(i):
        parent = by_index[i].parent
        return None if parent is None else by_index[parent].name

    mine = [i for i, s in by_index.items() if s.name == route]
    assert all(by_index[i].end_ns is not None and by_index[i].end_ns >= by_index[i].start_ns for i in mine)
    assert sum(inside(i) == "step.forward" for i in mine) == DEPTH
    # on the CPU autograd runs the backward on the calling thread, inside step.backward
    assert sum(inside(i) == "step.backward" for i in mine) == DEPTH * (2 if remat else 1)
    assert len(mine) == DEPTH * (3 if remat else 2)
    assert not [s for s in spans if s.name in ROUTES and s.name != route]
    assert calls == [{route: DEPTH, route + ".backward": DEPTH, **({route + ".recompute": DEPTH} if remat else {})}]


def test_backward_spans_cover_the_cores_backward_alone():
    """Each backward span holds one core's backward: the spans of one step
    do not overlap, and the backward ones close before step.backward does."""
    cfg = tiny_cfg(False)
    _, _, spans, _ = run_steps(cfg, batches(cfg, 1), record=True)
    mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "attn.relpos")
    assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
    back = next(s for s in spans if s.name == "step.backward")
    inner = [s for s in spans if s.name == "attn.relpos" and s.start_ns >= back.start_ns]
    assert len(inner) == DEPTH and all(s.end_ns <= back.end_ns for s in inner)


def test_counters_match_the_blocks_over_steps():
    cfg = tiny_cfg(True)
    _, calls, _, _ = run_steps(cfg, batches(cfg, 2))
    want = {"attn.relpos": DEPTH, "attn.relpos.recompute": DEPTH, "attn.relpos.backward": DEPTH}
    assert calls == [want, want]


def test_two_steps_bit_equal_with_recording_on_and_off():
    cfg = tiny_cfg(True)
    data = batches(cfg, 2)
    plain, _, _, _ = run_steps(cfg, data)
    recorded, _, spans, _ = run_steps(cfg, data, record=True)
    profiled, _, _, names = run_steps(cfg, data, profile=True)
    assert spans and names.count("attn.relpos") == 2 * 3 * DEPTH
    for n, p in plain.items():
        assert torch.equal(p, recorded[n]) and torch.equal(p, profiled[n]), n


def test_relative_position_indices_are_made_once_per_geometry(monkeypatch):
    """A step makes each relative position index on the host once, however
    many blocks, passes and steps use it: a copy from the host in every
    block's forward would wait for the card's queue to drain."""
    from advise_tpu_torch.models.layers import attention

    made = []
    plain = attention.rel_dist
    monkeypatch.setattr(attention, "rel_dist", lambda q, k: made.append((q, k)) or plain(q, k))
    monkeypatch.setattr(attention, "_ON_DEVICE", {})
    cfg = tiny_cfg(True)
    run_steps(cfg, batches(cfg, 2))
    assert made and len(made) == len(set(made))
    assert sorted(set(made)) == sorted(k[1] for k in attention._ON_DEVICE if k[0] == "dist")
