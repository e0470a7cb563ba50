"""The MViTv2-L MaskFeat cell (``mvitl_maskfeat.16x224``): the reference
``reference/mvitv2_maskfeat.py`` against the program's model, config and
parts, the whole train step against the program's in float32 at a tiny size
on the CPU, the faults it has to tell, the AdamW reader, the mask kind, the
relative-position roofline and its readers.

Tolerances (program against reference, float32, tiny): the first step's
loss within 1e-5 of it; ``grad1`` under 1e-4 and ``change`` under 5e-3
(rounding alone: the crop's weights and Adam's bias corrections are
computed in another order)."""

import copy
import math
import time

import numpy as np
import pytest
import torch

from harness import cell, check, inputs, manifest, weights as wmod
from harness.program import Program, port_config
from reference import mvitv2_maskfeat as R

ROOT = manifest.ROOT
M = manifest.load_manifest(ROOT)
CELL = "mvitl_maskfeat.16x224"
CPU = torch.device("cpu")


def _ctx():
    return manifest.resolve(M, CELL, ROOT)


def tiny_ctx(limits=None, videos=4):
    """The cell cut to 3 blocks of width 16 (32 after the transition at block
    1), 4 frames at 32^2, HOG in 4-pixel cells, the program in float32."""
    ctx = _ctx()
    spec, traffic = copy.deepcopy(ctx.spec), copy.deepcopy(ctx.traffic)
    p = spec["preset"]
    p["MVIT"].update(EMBED_DIM=16, NUM_HEADS=1, DEPTH=3, DIM_MUL=[[1, 2.0]], HEAD_MUL=[[1, 2.0], [2, 2.0]],
                     POOL_Q_STRIDE=[[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1]], POOL_KV_STRIDE_ADAPTIVE=[1, 2, 2])
    p["MASK"].update(PRETRAIN_DEPTH=[2], PRED_HOG_CELL_SZ=4)
    p["DATA"].update(NUM_FRAMES=4, BATCHSIZE_PER_GPU=videos, TRAIN_CROP_SIZE=32, TEST_CROP_SIZE=32)
    p["AUG"]["TARGET_SIZE"] = 32
    p["TPU"]["COMPUTE_DTYPE"] = "float32"
    rs = spec["reference_spec"]
    rs.update(embed_dim=16, num_heads=1, depth=3, frames=4, crop=32, stages=[1], kv_stride=[1, 2, 2],
              pretrain_depth=2, chunk=3)
    rs["hog"]["cell"] = 4
    rs["aug"]["crop"] = 32
    traffic.update(videos_per_step=videos, frames=4, ingest=[32, 43], pool=3, trace_steps=2, lr=1e-3)
    traffic["labels"]["grid"] = [2, 8, 8]
    traffic["limits"] = limits or {"grad1": 1e-4, "change": 5e-3}
    ctx.spec, ctx.traffic = spec, traffic
    return ctx


def _program_model(spec):
    from advise_tpu_torch.models import MODEL_REGISTRY, compute_dtype
    from advise_tpu_torch.models.layers.norm import get_norm

    cfg = port_config(spec)
    with torch.device("meta"):
        return cfg, MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg, get_norm(cfg), compute_dtype(cfg))


@pytest.mark.parametrize("size", ["published", "tiny"])
def test_reference_parameters_are_the_programs(size):
    spec = _ctx().spec if size == "published" else tiny_ctx().spec
    _, model = _program_model(spec)
    program = {n: tuple(p.shape) for n, p in model.named_parameters()}
    shapes = R.param_shapes(spec["reference_spec"])
    assert shapes == program
    kinds = wmod.plan(shapes, spec["weights"])  # every leaf has a rule
    if size == "published":
        assert len(shapes) == 1166 and sum(math.prod(s) for s in shapes.values()) == 213_257_520
        for name, (kind, _) in kinds.items():
            if name.endswith(("rel_pos_h", "rel_pos_w", "rel_pos_t", "cls_token", "mask_token")):
                assert kind == "xavier", name
            if name.endswith((".pool_q.weight", ".pool_k.weight", ".pool_v.weight", "patch_embed.proj.weight")):
                assert kind == "msra", name


def test_reference_spec_is_the_programs_config():
    spec = _ctx().spec
    cfg, model = _program_model(spec)
    rs, m = spec["reference_spec"], cfg.MVIT
    assert (m.EMBED_DIM, m.NUM_HEADS, m.DEPTH, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE) == (
        rs["embed_dim"], rs["num_heads"], rs["depth"], rs["frames"], rs["crop"])
    assert (list(m.PATCH_KERNEL), list(m.PATCH_STRIDE), list(m.PATCH_PADDING)) == (
        rs["patch"]["kernel"], rs["patch"]["stride"], rs["patch"]["padding"])
    assert (m.CLS_EMBED_ON, m.USE_ABS_POS, m.REL_POS_SPATIAL, m.REL_POS_TEMPORAL, m.RESIDUAL_POOLING,
            m.DIM_MUL_IN_ATT, m.QKV_BIAS, m.MODE) == (
        rs["cls_token"], rs["abs_pos"], rs["rel_pos_spatial"], rs["rel_pos_temporal"], rs["residual_pooling"],
        rs["dim_mul_in_att"], rs["qkv_bias"], "conv")
    assert not m.REV.ENABLE and not m.REL_POS_ZERO_INIT and m.DROPOUT_RATE == 0.0 and m.LAYER_SCALE_INIT_VALUE == 0.0
    assert math.isclose(m.MLP_RATIO, rs["mlp_ratio"]) and math.isclose(m.DROPPATH_RATE, rs["drop_path"])
    assert list(m.POOL_KVQ_KERNEL) == rs["pool_kernel"] and list(m.POOL_KV_STRIDE_ADAPTIVE) == rs["kv_stride"]
    # the program's schedule is the reference's block by block
    ref = R.blocks(rs)
    for i, blk in enumerate(model.encoder.schedule):
        r = ref[i]
        assert (blk["dim"], blk["dim_out"], blk["num_heads"], tuple(blk["input_size"])) == (
            r["dim"], r["dim_out"], r["heads"], r["thw"]), i
        assert tuple(blk["stride_q"]) == r["q_stride"] and tuple(blk["stride_kv"]) == r["kv_stride"], i
        assert r["dim_out"] // r["heads"] == 72
    assert [i for i, r in enumerate(ref) if r["q_stride"] != (1, 1, 1)] == rs["stages"]
    mk = cfg.MASK
    assert (mk.PRED_HOG, mk.PRED_HOG_NBINS, mk.PRED_HOG_CELL_SZ, list(mk.PRETRAIN_DEPTH), mk.MAE_RND_MASK,
            mk.HEAD_TYPE, mk.JOINT_CONTRASTIVE, mk.MAE_ON) == (
        True, rs["hog"]["nbins"], rs["hog"]["cell"], [rs["pretrain_depth"]], False, "separate", False, False)
    assert rs["pretrain_depth"] == rs["depth"] - 1
    aug = rs["aug"]
    assert (cfg.AUG.TYPE, cfg.AUG.TARGET_SIZE, cfg.AUG.MIN_AREA) == ("OnlyCrop", aug["crop"], aug["min_area"])
    assert list(cfg.AUG.RAND_CROP_RATIO) == aug["ratio"] and not cfg.DATA.REVERSE_INPUT_CHANNEL
    assert list(cfg.DATA.MEAN) == aug["mean"] and list(cfg.DATA.STD) == aug["std"]
    sol = rs["solver"]
    assert cfg.SOLVER.OPTIMIZING_METHOD == "adamw" and not cfg.SOLVER.LARS_ON and cfg.SOLVER.LAYER_DECAY == 1.0
    assert (list(cfg.SOLVER.BETAS), cfg.SOLVER.WEIGHT_DECAY, cfg.SOLVER.ZERO_WD_1D_PARAM, m.ZERO_DECAY_POS_CLS,
            cfg.SOLVER.CLIP_GRAD_NORM) == (sol["betas"], sol["weight_decay"], sol["zero_wd_1d"],
                                           sol["zero_decay_pos_cls"], sol["clip_grad_norm"])
    assert cfg.TPU.COMPUTE_DTYPE == spec["dtype"] == "bfloat16" and cfg.TPU.REMAT and spec["peak"] == "bf16"
    assert cfg.NUM_GPUS == 1 and spec["overrides"] == {"NUM_GPUS": 1} and list(spec["reduced"]) == ["NUM_GPUS"]
    assert rs["leave_out"] == [] and spec["loss_stat"] == "loss_mask"


def test_weight_decays_are_the_programs():
    from advise_tpu_torch.solver.optimizer import wd_tree

    spec = _ctx().spec
    cfg = port_config(spec)
    params = {n: torch.empty(s, device="meta") for n, s in R.param_shapes(spec["reference_spec"]).items()}
    assert wd_tree(cfg, params) == R.weight_decays(spec["reference_spec"])


def test_cell_lr_is_the_policys_at_its_epoch():
    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.solver.lr_policy import get_lr_at_epoch
    from advise_tpu_torch.solver.optimizer import adjust_base_lr

    ctx = _ctx()
    cfg = tconfig.get_cfg()
    cfg.merge_from_other_cfg(ctx.spec["preset"])
    cfg.NUM_WORLDS = cfg.NUM_GPUS  # the deployment's cards
    cfg = tconfig.assert_and_infer_cfg(cfg)
    adjust_base_lr(cfg)
    assert ctx.traffic["lr_epoch"] > cfg.SOLVER.WARMUP_EPOCHS
    assert ctx.traffic["lr"] == get_lr_at_epoch(cfg, ctx.traffic["lr_epoch"])


def test_cell_shapes_are_the_presets():
    ctx = _ctx()
    cfg = port_config(ctx.spec)
    t = ctx.traffic
    from advise_tpu_torch.data.device_aug import ingest_geometry

    assert (t["videos_per_step"], t["clips_per_video"], t["frames"]) == (
        cfg.DATA.BATCHSIZE_PER_GPU, cfg.DATA.NUM_CLIP, cfg.DATA.NUM_FRAMES)
    assert tuple(t["ingest"]) == ingest_geometry(cfg)[::-1]
    assert t["labels"] == {"kind": "maskfeat", "grid": list(R.patch_grid(ctx.spec["reference_spec"])),
                           "ratio": cfg.AUG.MASK_RATIO}


def test_hog_is_the_programs():
    from advise_tpu_torch.models.layers.operators import hog_features

    g = torch.Generator().manual_seed(2)
    frames = torch.rand(3, 32, 48, 3, generator=g) * 4 - 2
    torch.testing.assert_close(R.hog(frames, 9, 8, 16), hog_features(frames, 9, 8), rtol=1e-5, atol=1e-6)


def test_crop_is_the_programs():
    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.data.device_aug import RRCAug

    cfg = tconfig.get_cfg()
    cfg.merge_from_list(["AUG.TYPE", "OnlyCrop", "AUG.TARGET_SIZE", 24, "AUG.MIN_AREA", 0.5])
    g = torch.Generator().manual_seed(3)
    clips = torch.randint(0, 256, (3, 1, 2, 30, 41, 3), generator=g, dtype=torch.uint8)
    want = RRCAug(cfg)(clips, torch.Generator().manual_seed(9))
    aug = {"crop": 24, "min_area": 0.5, "ratio": [0.75, 4 / 3], "mean": list(cfg.DATA.MEAN), "std": list(cfg.DATA.STD)}
    got = R.only_crop(clips.reshape(3, 2, 30, 41, 3), aug, torch.Generator().manual_seed(9))
    torch.testing.assert_close(got, want.reshape(got.shape), rtol=1e-5, atol=1e-4)


def test_rel_pos_term_is_the_paper_sum():
    """The decomposed term equals q_i . (R^t + R^h + R^w) at each pair's
    offsets, summed pair by pair."""
    rs = copy.deepcopy(tiny_ctx().spec["reference_spec"])
    blk = R.blocks(rs)[1]  # the transition: q on 2x4x4, k on 2x8x8
    torch.manual_seed(0)
    att = R.Attention(blk, rs, R.Precision())
    for name in ("rel_pos_h", "rel_pos_w", "rel_pos_t"):
        getattr(att, name).data.normal_()
    q = torch.randn(1, att.heads, 1 + math.prod(blk["q_thw"]), att.hd)
    got = att.rel_pos(q)
    (qt, qh, qw), (kt, kh, kw) = blk["q_thw"], blk["k_thw"]
    it, ih, iw = (R.rel_index(a, b, "cpu") for a, b in ((qt, kt), (qh, kh), (qw, kw)))
    for i, (a, b_, c) in enumerate([(a, b_, c) for a in range(qt) for b_ in range(qh) for c in range(qw)][::5]):
        qi = q[0, 0, 1 + (a * qh + b_) * qw + c]
        for j, (x, y, z) in enumerate([(x, y, z) for x in range(kt) for y in range(kh) for z in range(kw)][::7]):
            r = att.rel_pos_t[it[a, x]] + att.rel_pos_h[ih[b_, y]] + att.rel_pos_w[iw[c, z]]
            want = torch.dot(qi, r)
            torch.testing.assert_close(got[0, 0, (a * qh + b_) * qw + c, (x * kh + y) * kw + z], want,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_program_and_reference_agree_in_float32_at_a_tiny_size(seed):
    ctx = tiny_ctx()
    spec, traffic = ctx.spec, ctx.traffic
    pool = inputs.make_pool(traffic, seed, CPU)
    start = wmod.make(R.param_shapes(spec["reference_spec"]), spec["weights"], seed, CPU)
    prog = Program(spec, traffic, seed, CPU)
    prog.load(start)
    got = cell.program_readings(prog, pool, spec, start, R.weight_decays(spec["reference_spec"]))
    want = cell.reference_readings(R, spec, traffic, pool, seed, CPU)
    assert got["losses"][0] == pytest.approx(want["losses"][0], rel=1e-5)
    assert all(math.isfinite(v) for v in want["grad1"].values())
    nums = check.numbers(got, want)
    assert nums["grad1"] < 1e-4 and nums["change"] < 5e-3, (nums, check.details(got, want))


def test_a_sound_tiny_run_is_correct():
    res = cell.run(tiny_ctx(), 21, 0.2, False, CPU, time.perf_counter())
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("left_out", ["rel_pos", "residual_pooling"])
def test_the_reference_without_a_mechanism_is_not_correct(left_out):
    ctx = tiny_ctx()
    pool = inputs.make_pool(ctx.traffic, 3, CPU)
    want = cell.reference_readings(R, ctx.spec, ctx.traffic, pool, 3, CPU)
    spec = copy.deepcopy(ctx.spec)
    spec["reference_spec"]["leave_out"] = [left_out]
    other = cell.reference_readings(R, spec, ctx.traffic, pool, 3, CPU)
    assert not check.judge(check.numbers(other, want), ctx.traffic["limits"])


def test_the_control_is_not_correct():
    ctx = tiny_ctx()
    pool = inputs.make_pool(ctx.traffic, 4, CPU)
    want = cell.reference_readings(R, ctx.spec, ctx.traffic, pool, 4, CPU)
    control = cell.reference_readings(R, ctx.spec, ctx.traffic, pool, 4, CPU, ctx.spec["control"])
    assert not check.judge(check.numbers(control, want), ctx.traffic["limits"])


def test_chunks_sum_to_the_whole_batch():
    ctx = tiny_ctx()
    spec, traffic = ctx.spec, ctx.traffic
    pool = inputs.make_pool(traffic, 6, CPU)
    start = wmod.make(R.param_shapes(spec["reference_spec"]), spec["weights"], 6, CPU)
    seeds = [inputs.step_seed(6, i) for i in range(2)]
    runs = []
    for chunk in (0, 1, 3):
        rs = dict(spec["reference_spec"], chunk=chunk)
        runs.append(R.run_steps(rs, start, pool[:2], seeds, traffic["lr"], CPU))
    for other in runs[1:]:
        assert other["losses"] == pytest.approx(runs[0]["losses"], rel=1e-5)
        for n, g in runs[0]["g1"].items():
            torch.testing.assert_close(other["g1"][n], g, rtol=1e-4, atol=1e-9)


def test_adamw_reader_recovers_a_known_first_gradient():
    from advise_tpu_torch.solver.optimizer import Adam

    solver = _ctx().spec["reference_spec"]["solver"]
    reader = manifest.solver("adamw")
    g = torch.Generator().manual_seed(8)
    params = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(7, generator=g)}
    grads = {n: torch.randn(p.shape, generator=g) * 3 for n, p in params.items()}
    wds = {"a": 0.05, "b": 0.0}
    tx = Adam(wds, *solver["betas"], clip_norm=solver["clip_grad_norm"])
    _, state = tx.update(grads, tx.init(params), params)
    got = reader.received(state, params, wds, solver)
    norm = torch.sqrt(sum(torch.sum(v * v) for v in grads.values()))
    for n, v in grads.items():
        torch.testing.assert_close(got[n], v / norm * solver["clip_grad_norm"], rtol=1e-6, atol=0)
    assert 0 < reader.SILENT < 0.1


def _masks(seed):
    ctx = _ctx()
    traffic = dict(ctx.traffic, pool=2)
    pool = inputs.make_pool(dict(traffic, videos_per_step=2, frames=1, ingest=[4, 4]), seed, CPU)
    return [b[1]["mask"] for b in pool]


@pytest.mark.parametrize("seed", [7, 2**40 + 3])
def test_mask_kind_is_deterministic_and_covers_its_share(seed):
    a, b = _masks(seed), _masks(seed)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    m = a[0]
    assert m.shape == (2, 1, 8, 56, 56) and m.dtype == torch.bool
    per_frame = m.reshape(-1, 56 * 56).sum(dim=1).float()
    target = int(round(0.4 * 8 * 56 * 56)) // 8
    assert bool((per_frame <= target).all()) and float(per_frame.mean()) >= target - 8
    assert 0.39 <= float(m.float().mean()) <= 0.40
    assert not torch.equal(_masks(seed + 1)[0], m)


def test_mask_blocks_follow_the_loader_rule():
    """Blocks of at least 4 patches, so no frame holds a lone masked patch
    run shorter than the rule allows: every masked patch has a masked
    neighbour in its row or column."""
    m = _masks(11)[0].reshape(-1, 56, 56).numpy()
    pad = np.pad(m, ((0, 0), (1, 1), (1, 1)))
    neighbours = pad[:, :-2, 1:-1] | pad[:, 2:, 1:-1] | pad[:, 1:-1, :-2] | pad[:, 1:-1, 2:]
    assert not (m & ~neighbours).any()


def test_relpos_roofline_counts_by_hand():
    from roofline import relpos_attention as RA

    (fo, fb), (bo, bb) = RA.counts(2, 3, 8, (2, 4, 4), (2, 2, 2), True)
    nq, nk, rows = 33, 9, 6
    assert fo == 2 * rows * nq * nk * 8 * 2 + 2 * rows * 32 * 6 * 8 and bo == 2 * fo
    tables = (2 * 2 + 4 * 2 + 4 * 2) * 8
    assert fb == 2 * (rows * (2 * nq * 8 + 2 * nk * 8) + tables)
    assert bb == 2 * (rows * (4 * nq * 8 + 4 * nk * 8) + 2 * tables)
    cores = R.attention_shapes(_ctx().spec["reference_spec"], 8)
    assert len(cores) == 48 and all(c["d"] == 72 and c["cls"] for c in cores)
    assert {c["k_thw"] for c in cores} == {(8, 7, 7), (8, 14, 14)}
    # a step's least time: about 2 TFLOP of products at the bf16 peak
    assert 1.5e-3 < RA.step_bound_s(cores) < 4e-3


def _record(ops):
    return {"device": [("k", 0, 4_000_000), ("k", 5_000_000, 6_000_000)], "ops": ops, "steps": 2,
            "spec": _ctx().spec, "traffic": _ctx().traffic}


@pytest.mark.parametrize("name", ["relpos_attn_pct", "relpos_attn_roofline_pct"])
def test_relpos_readers_read_the_spans_or_nothing(name):
    reader = manifest.reader(name, ROOT)
    assert reader.HOST_OPS == ("attn.relpos",)
    assert reader.read(_record([])) is None  # a program without the spans (the parent's)
    assert reader.read(_record([{"name": "aten::mm", "device_s": 1.0}])) is None
    value = reader.read(_record([{"name": "attn.relpos", "device_s": 0.004},
                                 {"name": "attn.relpos", "device_s": 0.001}]))
    assert value is not None and value > 0
    if name == "relpos_attn_pct":
        assert value == pytest.approx(50.0)


def test_traced_host_operators_of_the_cell_are_its_readers():
    from harness import trace

    ctx = _ctx()
    assert trace.host_ops(manifest.reader(m["name"], ROOT) for m in ctx.per_layer) == ("attn.relpos",)
    assert {m["name"] for m in ctx.per_layer} == {"launches_per_step", "device_idle_pct", "mfu_pct",
                                                  "relpos_attn_pct", "relpos_attn_roofline_pct"}
    assert {m["name"] for m in ctx.end_to_end} == {"clips_per_s", "peak_mem_gib", "setup_s"}


def test_a_traced_tiny_run_reads_the_spans():
    """On the CPU the profiler records the host spans; the device lists are
    empty, so the readers return None rather than raising."""
    import run

    ctx = tiny_ctx()
    res = cell.run(ctx, 5, 0.2, True, CPU, time.perf_counter())
    names = [c["name"] for c in res["record"]["ops"]]
    assert names.count("attn.relpos") == 3 * 3 * ctx.traffic["trace_steps"]  # forward, recompute, backward
    line = run.result_line(ctx, res, True, {})
    assert set(line["metrics"]) <= {m["name"] for m in ctx.per_layer}
