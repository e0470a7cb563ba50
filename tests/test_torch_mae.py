"""The port's MAE path and the rest of MaskMViT (advise_tpu_torch/models/
masked.py, the masked train step, utils/visualization.py, the trainer's
VIS_MASK hook) against the JAX package's, on the CPU in float32.

Inputs come from numpy with a seed. JAX's random masks cannot be replayed in
torch: the tests wrap JAX's ``random_masking`` to record what its programs
drew (``torch_port_common.record_jax_masks``) and hand those indices to the
port, or hand both sides the same noise.

Tolerances: random_masking's ids and mask EQUAL, given JAX's noise;
patchify_3d, unpatchify_3d and normalize_patches within 1e-6 of the largest
value; the MAE forward's preds, labels, mask and loss, and every parameter
gradient, within 1e-4 (``grads_agree``: also 1e-6 of the tree's largest
gradient, for gradients that are zero in exact arithmetic), the VIS triple
within 1e-5; the dump's .npy within 1e-4; the 3-step AdamW trajectory as
tests/test_torch_step.py holds one (lr 1e-4, what each tensor moved within
5e-2 of JAX's move plus 1e-6 of the tree's largest value).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.engine.steps import masked_task_loss as jmasked_task_loss
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models import masked as jmasked
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu.utils.visualization import dump_mask_visualization as jdump
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_train_step, masked_task_loss
from advise_tpu_torch.engine.train import trainer
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.masked import (
    normalize_patches,
    patchify_3d,
    random_masking,
    unpatchify_3d,
)
from advise_tpu_torch.solver import optimizer as topt
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import params_to_torch
from advise_tpu_torch.utils.visualization import dump_mask_visualization, vis_dir

from torch_port_common import (
    MAE_B, MAE_S, MAE_T, grads_agree, hand_port_masks, mae_cfg, model_variables, on_mesh,
    optimizer_masks_disagree, record_jax_masks, rel_err,
)

torch.set_num_threads(1)

LR = float(np.float32(1e-4))
STEPS = 3


@pytest.mark.parametrize("b,thw,ratio,tube,per_frame", [
    (3, (2, 4, 4), 0.75, False, False),
    (2, (8, 14, 14), 0.9, False, False),  # ViT-B/16's 1568 tokens: 156 kept
    (2, (3, 4, 4), 0.6, True, False),
    (2, (4, 4, 4), 0.75, False, True),
    (3, (2, 3, 3), 0.5, False, True),
])
def test_random_masking_equals_jax(b, thw, ratio, tube, per_frame):
    key = jax.random.PRNGKey(7)
    t, h, w = thw
    shape = (b, t, h * w) if per_frame else ((b, 1, h * w) if tube else (b, t * h * w))
    noise = np.asarray(jax.random.uniform(key, shape))
    want = [np.asarray(a) for a in jmasked.random_masking(key, b, thw, ratio, tube=tube, per_frame=per_frame)]
    got = [a.numpy() for a in random_masking(b, thw, ratio, tube=tube, per_frame=per_frame,
                                             noise=torch.from_numpy(noise))]
    for name, g, wv in zip(("ids_keep", "mask", "ids_restore"), got, want):
        assert g.shape == wv.shape and np.array_equal(g, wv), name
    if (b, thw) == (2, (8, 14, 14)):
        assert got[0].shape == (2, 156)


def test_random_masking_draws_from_the_generator():
    a = random_masking(2, (2, 4, 4), 0.75, generator=torch.Generator().manual_seed(3))
    b = random_masking(2, (2, 4, 4), 0.75, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (2, 8) and float(a[1].sum()) == 2 * 24
    with pytest.raises(ValueError, match="Generator"):
        random_masking(2, (2, 4, 4), 0.75)


@pytest.mark.parametrize("u", [1, 2])
def test_patchify_unpatchify_normalize_match_jax(u):
    x = np.random.default_rng(0).standard_normal((2, 4, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jmasked.patchify_3d(jnp.asarray(x), 4, u))
    got = patchify_3d(torch.from_numpy(x), 4, u).numpy()
    assert got.shape == want.shape and rel_err(got, want) <= 1e-6
    thw = (4 // u, 4, 6)
    assert rel_err(unpatchify_3d(torch.from_numpy(got), thw, 4, u).numpy(),
                   jmasked.unpatchify_3d(jnp.asarray(want), thw, 4, u)) <= 1e-6
    assert np.array_equal(unpatchify_3d(torch.from_numpy(got), thw, 4, u).numpy(), x)
    assert rel_err(normalize_patches(torch.from_numpy(got)).numpy(),
                   jmasked.normalize_patches(jnp.asarray(want))) <= 1e-6


def _clips(i, b=MAE_B):
    rng = np.random.default_rng(200 + i)
    return rng.standard_normal((b, 1, MAE_T, MAE_S, MAE_S, 3)).astype(np.float32)


# the MAE forward's cases: the preset cut to size, then one knob each
MAE_CASES = {
    "preset": {},
    "sep_dec_pos": {"MASK.DECODER_SEP_POS_EMBED": True},
    "no_time_stride_loss": {"MASK.TIME_STRIDE_LOSS": False},
    "per_frame": {"MASK.PER_FRAME_MASKING": True},
    "tube": {"AUG.MASK_TUBE": True},
    "fixed_sincos": {"MVIT.USE_FIXED_SINCOS_POS": True},
    "dec_kv_pool_no_norm_pix": {"MASK.DEC_KV_KERNEL": [3, 3, 3], "MASK.DEC_KV_STRIDE": [1, 2, 2],
                                "MASK.NORM_PRED_PIXEL": False},
}


@pytest.mark.parametrize("case", list(MAE_CASES))
def test_mae_forward_loss_and_grads_match_jax(case, monkeypatch):
    """The MAE model in training with JAX's recorded masks: preds, labels,
    mask and the VIS triple against JAX's forward; the loss (the masked
    train step's, VIS videos dropped) and every parameter gradient against
    JAX's masked_task_loss."""
    jcfg, tcfg = mae_cfg(jconfig, **MAE_CASES[case]), mae_cfg(tconfig, **MAE_CASES[case])
    jm = jbuild_model(jcfg, sync_axes=())
    params = model_variables(jm, MAE_T, MAE_S)
    drawn = record_jax_masks(monkeypatch)
    clips = _clips(0)
    x = jnp.asarray(clips[:, 0])
    out_j = jax.jit(lambda p: jm.apply({"params": p}, x, train=True,
                                       rngs={"mask": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(0)}))(params)

    def jloss(p):
        loss, (_, stats) = jmasked_task_loss(jcfg, jm, p, {}, jnp.asarray(clips), {}, jax.random.PRNGKey(0),
                                             train=False)
        return loss

    loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(params)
    jax.effects_barrier()
    assert len(drawn) == 2
    fwd_masks, loss_masks = drawn

    tm = build_model(tcfg, "cpu")
    tm.load_state_dict(params_to_torch(params))
    tm.train()
    handed = tuple(torch.from_numpy(np.array(a)) for a in fwd_masks)
    out_t = tm(torch.from_numpy(clips[:, 0]), masking=handed)
    assert len(out_t) == len(out_j) == 5
    for name, a, b in (("pred", out_t[0][0], out_j[0][0]), ("label", out_t[1][0], out_j[1][0]),
                       ("mask", out_t[2][0], out_j[2][0])):
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel_err(a.detach().numpy(), b) <= 1e-4, name
    frames = MAE_T // 2 if tcfg.MASK.TIME_STRIDE_LOSS else MAE_T  # the label's frames
    for a, b in zip(out_t[4], out_j[4]):
        assert tuple(a.shape) == tuple(b.shape) == (MAE_B, frames, MAE_S, MAE_S, 3)
        assert rel_err(a.numpy(), b) <= 1e-5

    hand_port_masks(monkeypatch, [loss_masks])
    loss_t, stats_t = masked_task_loss(tcfg, tm, torch.from_numpy(clips), {}, None)
    assert set(stats_t) == {"loss_mask"}
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-4)
    params_t = dict(tm.named_parameters())
    grads = dict(zip(params_t, (g.numpy() for g in torch.autograd.grad(loss_t, list(params_t.values())))))
    assert not grads_agree(grads, params_to_torch(jax.device_get(g_j)), 1e-4)


def test_mae_tree_and_optimizer_masks_match_jax():
    """The port's MAE tree converts from JAX's name for name (learned and
    separable decoder tables); the fixed sin-cos table is a buffer outside
    the state_dict, as JAX keeps no parameter for it. Under the preset's
    AdamW with ZERO_WD_1D_PARAM every parameter's label and weight decay
    equal JAX's: the position tables and the mask token are not decayed."""
    for over in ({}, {"MASK.DECODER_SEP_POS_EMBED": True}, {"MVIT.USE_FIXED_SINCOS_POS": True}):
        jcfg, tcfg = mae_cfg(jconfig, **over), mae_cfg(tconfig, **over)
        jparams = model_variables(jbuild_model(jcfg, sync_axes=()), MAE_T, MAE_S)
        params = params_to_torch(jparams)
        tm = build_model(tcfg, "cpu")
        own = dict(tm.named_parameters())
        assert set(own) == set(params)
        assert all(tuple(own[k].shape) == tuple(v.shape) for k, v in params.items())
        assert ("pos_embed" in own) != bool(over.get("MVIT.USE_FIXED_SINCOS_POS"))
        assert tcfg.SOLVER.ZERO_WD_1D_PARAM and tcfg.SOLVER.WEIGHT_DECAY > 0
        assert not optimizer_masks_disagree(jcfg, tcfg, jparams, tm)
        wd = topt.wd_tree(tcfg, own)
        tables = [n for n in own if "pos_embed" in n or n == "mask_token"]
        assert len(tables) >= 2 and all(wd[n] == 0.0 for n in tables)
        assert wd["blocks_0.attn.qkv.weight"] > 0


def test_scale_init_by_depth_divides_the_initial_weights():
    """MASK.SCALE_INIT_BY_DEPTH: block i's attention projection (Flax's
    truncated_normal(0.02): std 0.02 x 0.8796 after the truncation at two
    standard deviations) and fc2 (lecun normal) start with their std divided
    by sqrt(2 (i + 1)), in the port's draw as in JAX's (within 10 %:
    9,216-element draws)."""
    over = {"MASK.SCALE_INIT_BY_DEPTH": True, "MVIT.EMBED_DIM": 96, "MVIT.DEPTH": 3,
            "MASK.PRETRAIN_DEPTH": [2]}
    jparams = model_variables(jbuild_model(mae_cfg(jconfig, **over), sync_axes=()), MAE_T, MAE_S)
    tm = build_model(mae_cfg(tconfig, **over), "cpu", seed=3)
    for i in range(3):
        div = (2.0 * (i + 1)) ** 0.5
        blk = getattr(tm, f"blocks_{i}")
        jb = jparams[f"blocks_{i}"]
        for got, want, std in ((blk.attn.proj.weight, jb["attn"]["proj"]["kernel"], 0.02 * 0.8796 / div),
                               (blk.mlp.fc2.weight, jb["mlp"]["fc2"]["kernel"], (1.0 / 384) ** 0.5 / div)):
            assert float(got.detach().std()) == pytest.approx(std, rel=0.1)
            assert float(np.std(want)) == pytest.approx(std, rel=0.1)
        assert float(blk.mlp.fc1.weight.detach().std()) == pytest.approx((1.0 / 96) ** 0.5, rel=0.1)


def _maskfeat_cfg(mod, **overrides):
    """configs/chip/maskfeat_minik400.yaml with in-model masks (tube, ratio
    0.4) and pixel targets, cut to CPU size: 4 blocks 16 -> 32 -> 64 wide
    with Q pooling at blocks 1 and 3, heads at depths 1 and 3 (grids 2 x 4
    x 4 and 2 x 2 x 2, pixel strides 8 and 16), 4 frames at 32^2, no drop
    path, float32."""
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/chip/maskfeat_minik400.yaml")
    over = {"NUM_WORLDS": 1, "TPU.COMPUTE_DTYPE": "float32", "TPU.DONATE": False, "TPU.REMAT": False,
            "MVIT.EMBED_DIM": 16, "MVIT.DEPTH": 4, "MVIT.DROPPATH_RATE": 0.0, "MASK.PRETRAIN_DEPTH": [1, 3],
            "MASK.MAE_RND_MASK": True, "MASK.PRED_HOG": False, "MASK.DECODER_EMBED_DIM": 32,
            "DATA.NUM_FRAMES": MAE_T, "DATA.TRAIN_CROP_SIZE": MAE_S, "DATA.TEST_CROP_SIZE": MAE_S,
            "AUG.TARGET_SIZE": MAE_S, "DATA.BATCHSIZE_PER_GPU": MAE_B, **overrides}
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return mod.assert_and_infer_cfg(cfg)


@pytest.mark.parametrize("over", [
    {"MASK.HEAD_TYPE": "separate_xformer", "MASK.DECODER_DEPTH": 1},
    {"MASK.HEAD_TYPE": "separate", "MASK.TIME_STRIDE_LOSS": False, "MASK.NORM_PRED_PIXEL": False},
], ids=["xformer_heads", "plain_heads_all_frames"])
def test_maskfeat_in_model_masks_pixel_targets_match_jax(over, monkeypatch):
    """MaskFeat with MASK.MAE_RND_MASK (the model draws its tube masks) and
    pixel targets, with 'separate_xformer' heads (a decoder block 32 wide
    per depth; the depth-3 one projects from 64) or plain ones over every
    frame: preds, labels and pooled masks against JAX's forward with its
    recorded masks, the loss and every gradient against its
    masked_task_loss."""
    jcfg, tcfg = _maskfeat_cfg(jconfig, **over), _maskfeat_cfg(tconfig, **over)
    jm = jbuild_model(jcfg, sync_axes=())
    params = model_variables(jm, MAE_T, MAE_S)
    drawn = record_jax_masks(monkeypatch)
    clips = _clips(1)
    out_j = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(clips[:, 0]), train=True,
                                       rngs={"mask": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(0)}))(params)

    def jloss(p):
        return jmasked_task_loss(jcfg, jm, p, {}, jnp.asarray(clips), {}, jax.random.PRNGKey(0), train=False)[0]

    loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(params)
    jax.effects_barrier()
    assert len(drawn) == 2
    tm = build_model(tcfg, "cpu")
    tm.load_state_dict(params_to_torch(params))
    tm.train()
    hand_port_masks(monkeypatch, drawn)
    out_t = tm(torch.from_numpy(clips[:, 0]))
    assert len(out_t) == len(out_j) == 4 and len(out_t[0]) == 2
    for d in range(2):
        for name, a, b in (("pred", out_t[0][d], out_j[0][d]), ("label", out_t[1][d], out_j[1][d]),
                           ("mask", out_t[2][d], out_j[2][d])):
            assert tuple(a.shape) == tuple(b.shape), (d, name)
            assert rel_err(a.detach().numpy(), b) <= 1e-4, (d, name)
    assert 0 < float(out_t[2][0].mean()) < 1
    loss_t, _ = masked_task_loss(tcfg, tm, torch.from_numpy(clips), {}, None)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-4)
    params_t = dict(tm.named_parameters())
    grads = dict(zip(params_t, (g.numpy() for g in torch.autograd.grad(loss_t, list(params_t.values())))))
    assert not grads_agree(grads, params_to_torch(jax.device_get(g_j)), 1e-4)


def test_mae_step_trajectory_matches_jax(monkeypatch):
    """Three MAE steps (AdamW with weight decay 0.05, ZERO_WD_1D_PARAM, the
    VIS videos dropped) from the same initial params, each with the masks
    JAX's step drew: losses, grad norms, params and Adam's moments."""
    jcfg, tcfg = mae_cfg(jconfig), mae_cfg(tconfig)
    params = model_variables(jbuild_model(jcfg, sync_axes=()), MAE_T, MAE_S)
    drawn = record_jax_masks(monkeypatch)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats={}, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl={}), mesh)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    jstats = []
    for i in range(STEPS):
        jstate, st = jstep(jstate, jnp.asarray(_clips(i)), {}, jax.random.PRNGKey(i), jnp.float32(LR))
        jstats.append(jax.device_get(st))
    jax.effects_barrier()
    assert len(drawn) == STEPS

    tm = build_model(tcfg, "cpu")
    tm.load_state_dict(params_to_torch(params))
    tp = dict(tm.named_parameters())
    tbundle = build_tx(tcfg, tp)
    tstate = TrainState(tm, tbundle.tx.init(tp), 0)
    tstep = make_train_step(tcfg, tbundle, None)
    hand_port_masks(monkeypatch, drawn)
    for i in range(STEPS):
        tstats = tstep(tstate, torch.from_numpy(_clips(i)), {}, None, LR)
        assert float(tstats["loss_mask"]) == pytest.approx(float(jstats[i]["loss_mask"]), rel=1e-4), i
        assert float(tstats["grad_norm"]) == pytest.approx(float(jstats[i]["grad_norm"]), rel=1e-3), i
    jstate = jax.device_get(jstate)
    adam = [s for s in jstate.opt_state if hasattr(s, "mu")][0]
    assert tstate.step == int(jstate.step) == STEPS and tstate.opt_state["count"] == int(adam.count)
    p0 = params_to_torch(params)
    zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
    for got, want, init in ((tm.state_dict(), params_to_torch(jstate.params), p0),
                            (tstate.opt_state["mu"], params_to_torch(adam.mu), zeros),
                            (tstate.opt_state["nu"], params_to_torch(adam.nu), zeros)):
        top = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            g, w, i0 = (np.asarray(a, np.float32) for a in (got[k].detach(), v, init[k]))
            err, bound = float(np.abs(g - w).max()), 5e-2 * float(np.abs(w - i0).max()) + 1e-6 * top
            assert err <= bound, (k, err, bound)


def test_dump_mask_visualization_writes_jax_values_without_cv2(tmp_path, monkeypatch):
    """The epoch-end dump on already-augmented clips (no device aug), JAX's
    masks handed over: the port writes JAX's .npy files (1e-4) in JAX's
    directory layout, and no .mp4 where cv2 does not import."""
    jcfg, tcfg = mae_cfg(jconfig), mae_cfg(tconfig)
    jcfg.LOGDIR, tcfg.LOGDIR = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = jbuild_model(jcfg, sync_axes=())
    params = model_variables(jm, MAE_T, MAE_S)
    drawn = record_jax_masks(monkeypatch)
    clips = _clips(5, b=5)  # more clips than the dump's 4
    jdir = jdump(jcfg, jm, params, {}, jnp.asarray(clips), None, jax.random.PRNGKey(3), epoch=2)
    jax.effects_barrier()
    assert len(drawn) == 1
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    hand_port_masks(monkeypatch, drawn)
    tm = build_model(tcfg, "cpu")
    tm.load_state_dict(params_to_torch(params))
    pdir = dump_mask_visualization(tcfg, tm, torch.from_numpy(clips), None, None, epoch=2)
    assert pdir == vis_dir(tcfg) and pdir.replace(str(tmp_path / "port"), "") == jdir.replace(
        str(tmp_path / "jax"), "")
    import os

    names = sorted(os.listdir(pdir))
    assert names == [f"vis_2_{i}.npy" for i in range(4)]
    for name in names:
        got, want = np.load(os.path.join(pdir, name)), np.load(os.path.join(jdir, name))
        assert got.shape == want.shape == (3, MAE_T // 2, MAE_S, MAE_S, 3)
        assert rel_err(got, want) <= 1e-4


def test_trainer_writes_the_vis_mask_dump(tmp_path):
    """mae_vismask cut to size through ``engine.train.trainer`` on the CPU:
    8 synthetic videos, 2 epochs of 2 iterations; each epoch's end writes 2
    triples (the batch's 2 clips) whose reconstruction EQUALS the input on
    every visible patch and whose masked input is zero on 3/4 of them (and,
    where cv2 imports, their .mp4)."""
    cfg = mae_cfg(tconfig, **{"DATA.DECODE_BACKEND": "synthetic", "DATA.SYNTHETIC_SIZE": 4,
                              "DATA.SYNTHETIC_RES": 48, "DATA.WORKERS": 2, "SOLVER.MAX_EPOCH": 2,
                              "TRAIN.SAVE_FREQ": 1, "TRAIN.AUTO_RESUME": False})
    cfg.LOGDIR = str(tmp_path)
    record = {}
    trainer(cfg, device="cpu", record=record)
    assert len(record["stats"]) == 4 and all(np.isfinite(st["loss_mask"]) for st in record["stats"])
    import os

    out = vis_dir(cfg)
    npys = sorted(n for n in os.listdir(out) if n.endswith(".npy"))
    assert npys == [f"vis_{e}_{i}.npy" for e in range(2) for i in range(2)]
    p = 4  # the patch's pixels: crop 32 over the 8 x 8 grid, one frame a token (TIME_STRIDE_LOSS)
    for name in npys:
        raw, masked, rec = np.load(os.path.join(out, name))
        assert raw.shape == (MAE_T // 2, MAE_S, MAE_S, 3)  # the label's frames, every second one
        patches = lambda v: v.reshape(2, 8, p, 8, p, 3).transpose(0, 1, 3, 2, 4, 5).reshape(128, -1)
        hidden = np.all(patches(masked) == 0, axis=1)
        assert int(hidden.sum()) == 128 - 32
        assert np.array_equal(patches(rec)[~hidden], patches(raw)[~hidden])
        assert not np.array_equal(patches(rec)[hidden], patches(raw)[hidden])
