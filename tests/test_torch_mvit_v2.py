"""MViTv2's options in the port (advise_tpu_torch/models/layers/attention.py,
models/mvit.py, models/utils.py) against the JAX package's, on the CPU in
float32: the decomposed relative position biases (MVIT.REL_POS_SPATIAL /
REL_POS_TEMPORAL, their tables grown and shrunk), residual pooling,
DIM_MUL_IN_ATT, the fixed sin-cos tables (MVIT.USE_FIXED_SINCOS_POS), and
the step of MViT_S_rev_masked.yaml at a reduced MViT-S.

Tolerances: the sin-cos tables EQUAL; a resized table within 1e-6 of the
largest value (``jax.image.resize`` contracts its weights in another
order); a module's output and every gradient within 1e-5, a whole model's
within 1e-4 (``grads_agree``: also 1e-2 of that of the tree's largest
gradient, for gradients zero in exact arithmetic); the step trajectory as
tests/test_torch_step.py holds one (lr 1e-4, what each tensor moved within
5e-2 of JAX's move plus 1e-6 of the tree's largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models import utils as jutils
from advise_tpu.models.layers import attention as jattn
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_train_step
from advise_tpu_torch.engine.train import check_ported
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models import utils as tutils
from advise_tpu_torch.models.layers import attention as tattn
from advise_tpu_torch.ops import flash_attention as fa
from advise_tpu_torch.solver import optimizer as topt
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import params_to_torch
from tests.test_transformers import _mvit_cfg

from torch_port_common import (
    _override, grads_agree, loader_masks, masked_cfg, model_variables, on_mesh, optimizer_masks_disagree,
    rel_err,
)

torch.set_num_threads(1)

LR = float(np.float32(1e-4))
STEPS = 3
V2 = {"MVIT.REL_POS_SPATIAL": True, "MVIT.REL_POS_TEMPORAL": True, "MVIT.RESIDUAL_POOLING": True,
      "MVIT.DIM_MUL_IN_ATT": True}


def _port_cfg(jcfg):
    tcfg = tconfig.get_cfg()
    tcfg.merge_from_other_cfg(jcfg.to_dict())
    return tcfg


@pytest.mark.parametrize("cls", [False, True])
def test_sincos_tables_equal_jax(cls):
    assert np.array_equal(tutils.get_1d_sincos_pos_embed(8, 5, cls), jutils.get_1d_sincos_pos_embed(8, 5, cls))
    assert np.array_equal(tutils.get_2d_sincos_pos_embed(16, 4, cls), jutils.get_2d_sincos_pos_embed(16, 4, cls))
    got, want = tutils.get_3d_sincos_pos_embed(96, 7, 4, cls), jutils.get_3d_sincos_pos_embed(96, 7, 4, cls)
    assert got.dtype == want.dtype == np.float32 and got.shape == (4 * 49 + cls, 96)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_in,n_out", [(5, 7), (7, 5), (15, 7), (7, 3), (3, 15), (9, 9), (1, 5), (6, 1)])
def test_rel_pos_table_resize_matches_jax(n_in, n_out):
    """Grown (half-pixel linear) and shrunk (the triangle widened: JAX
    antialiases) tables against ``jax.image.resize(..., 'linear')``, with
    the gradient through the resize."""
    table = np.random.default_rng(n_in * 10 + n_out).standard_normal((n_in, 6)).astype(np.float32)
    want = np.asarray(jattn._rel_pos_table(jnp.asarray(table), n_out))
    t = torch.from_numpy(table).requires_grad_()
    got = tattn.rel_pos_table(t, n_out)
    assert got.shape == want.shape == (n_out, 6)
    assert rel_err(got.detach().numpy(), want) <= 1e-6
    g_out = np.random.default_rng(1).standard_normal((n_out, 6)).astype(np.float32)
    got.backward(torch.from_numpy(g_out))
    gj = jax.grad(lambda x: jnp.sum(jattn._rel_pos_table(x, n_out) * g_out))(jnp.asarray(table))
    assert rel_err(t.grad.numpy(), gj) <= 1e-6


@pytest.mark.parametrize("cls", [False, True])
@pytest.mark.parametrize("q_shape,k_shape,lens", [((2, 4, 4), (2, 4, 4), (7, 7, 3)),
                                                  ((2, 4, 3), (1, 2, 2), (5, 9, 7)),
                                                  ((1, 2, 2), (2, 4, 4), (11, 3, 5))])
def test_add_rel_pos_matches_jax(cls, q_shape, k_shape, lens):
    """The spatial and temporal terms on scores [B, H, Nq, Nk], with and
    without a cls row and column, at pooled K (or Q) grids and tables of
    other lengths than the grids need (resized both ways)."""
    rng = np.random.default_rng(3)
    sp = 1 if cls else 0
    nq, nk = int(np.prod(q_shape)) + sp, int(np.prod(k_shape)) + sp
    attn = rng.standard_normal((2, 2, nq, nk)).astype(np.float32)
    q = rng.standard_normal((2, 2, nq, 4)).astype(np.float32)
    rel_h, rel_w, rel_t = (rng.standard_normal((n, 4)).astype(np.float32) for n in lens)
    want = jattn.add_rel_pos_spatial(jnp.asarray(attn), jnp.asarray(q), cls, q_shape, k_shape,
                                     jnp.asarray(rel_h), jnp.asarray(rel_w))
    want = jattn.add_rel_pos_temporal(want, jnp.asarray(q), cls, q_shape, k_shape, jnp.asarray(rel_t))
    t = lambda a: torch.from_numpy(a)
    got = tattn.add_rel_pos_spatial(t(attn), t(q), cls, q_shape, k_shape, t(rel_h), t(rel_w))
    got = tattn.add_rel_pos_temporal(got, t(q), cls, q_shape, k_shape, t(rel_t))
    assert rel_err(got.numpy(), want) <= 1e-6
    if cls:  # the cls token's row and column keep their scores
        assert np.array_equal(got.numpy()[:, :, 0], attn[:, :, 0])
        assert np.array_equal(got.numpy()[:, :, :, 0], attn[:, :, :, 0])


# (grid the tokens lie on, the block's input_size, q/kv kernels and strides):
# tables of the input_size's length grown to the pooled grids' (7 -> 4: conv
# arithmetic rounds up), and shrunk where the tokens lie on a smaller grid
# than input_size or q and kv both pool in time
ATTN_CASES = {
    "same_grid": ((2, 8, 8), (2, 8, 8), (3, 3, 3), (3, 3, 3), (1, 2, 2), (1, 4, 4)),
    "grown": ((2, 7, 7), (2, 7, 7), (3, 3, 3), (3, 3, 3), (1, 2, 2), (1, 4, 4)),
    "shrunk_space": ((2, 4, 4), (2, 8, 8), (), (), (), ()),
    "shrunk_time": ((4, 4, 4), (4, 4, 4), (3, 3, 3), (3, 3, 3), (2, 1, 1), (2, 2, 2)),
}


@pytest.mark.parametrize("res_pool", [True, False])
@pytest.mark.parametrize("cls", [False, True])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_rel_pos_attention_matches_jax(case, cls, res_pool):
    """MultiScaleAttention with both relative position biases (flash asked
    for, and off: rel-pos blocks run the dense chain, as in JAX), with and
    without residual pooling and a cls token: output and every gradient,
    the tables' included."""
    thw, input_size, kq, kkv, sq, skv = ATTN_CASES[case]
    n = int(np.prod(thw)) + (1 if cls else 0)
    x = np.random.default_rng(0).standard_normal((2, n, 12)).astype(np.float32)
    kw = dict(num_heads=2, qkv_bias=True, kernel_q=kq, kernel_kv=kkv, stride_q=sq, stride_kv=skv,
              has_cls_embed=cls, flash=True, rel_pos_spatial=True, rel_pos_temporal=True,
              residual_pooling=res_pool)
    jmod = jattn.MultiScaleAttention(dim_out=16, input_size=input_size, **kw)
    tmod = tattn.MultiScaleAttention(12, 16, input_size=input_size, **kw)
    assert not tmod.flash
    params = jax.device_get(jax.jit(lambda: jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), thw))())["params"]
    assert {"rel_pos_h", "rel_pos_w", "rel_pos_t"} <= set(params)

    def jloss(p, xx):
        out = jmod.apply({"params": p}, xx, thw)
        return jnp.sum(out[0] * jnp.sin(out[0])), out

    (_, out_j), (gp, gx) = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(params, jnp.asarray(x))
    tmod.load_state_dict(params_to_torch(params))
    xt = torch.from_numpy(x).requires_grad_()
    launches = fa.flash_mha_fwd.launches
    out_t = tmod(xt, thw)
    torch.sum(out_t[0] * torch.sin(out_t[0])).backward()
    assert fa.flash_mha_fwd.launches == launches
    assert tuple(out_t[1]) == tuple(out_j[1])
    assert rel_err(out_t[0].detach().numpy(), out_j[0]) <= 1e-5
    assert rel_err(xt.grad.numpy(), gx) <= 1e-5
    grads = {name: p.grad.numpy() for name, p in tmod.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(gp)), 1e-5)


def test_rel_pos_zero_init_and_the_flash_switch():
    """REL_POS_ZERO_INIT starts the tables at zero (trunc 0.02 otherwise);
    without rel-pos the flash request stands."""
    from advise_tpu_torch.models.layers.common import init_weights

    kw = dict(input_size=(2, 8, 8), rel_pos_spatial=True, rel_pos_temporal=True, flash=True)
    zero = init_weights(tattn.MultiScaleAttention(8, 8, 2, rel_pos_zero_init=True, **kw),
                        torch.Generator().manual_seed(0))
    drawn = init_weights(tattn.MultiScaleAttention(8, 8, 2, **kw), torch.Generator().manual_seed(0))
    for name in ("rel_pos_h", "rel_pos_w", "rel_pos_t"):
        assert not getattr(zero, name).any()
        assert getattr(drawn, name).abs().max() > 0
    assert tuple(drawn.rel_pos_h.shape) == (15, 4) and tuple(drawn.rel_pos_t.shape) == (3, 4)
    assert not zero.flash and tattn.MultiScaleAttention(8, 8, 2, flash=True).flash


@pytest.mark.parametrize("cls", [False, True])
@pytest.mark.parametrize("dim_mul_in_att", [True, False])
def test_v2_block_matches_jax(dim_mul_in_att, cls):
    """A Q-pooling block that doubles the width with rel-pos and residual
    pooling; DIM_MUL_IN_ATT widens the attention and projects the skip from
    the normalised input before its pool (else the MLP's skip from norm2)."""
    thw = (2, 8, 8)
    n = 2 * 8 * 8 + (1 if cls else 0)
    x = np.random.default_rng(1).standard_normal((2, n, 8)).astype(np.float32)
    kw = dict(num_heads=2, mlp_ratio=4.0, qkv_bias=True, kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3),
              stride_q=(1, 2, 2), stride_kv=(1, 2, 2), has_cls_embed=cls, rel_pos_spatial=True,
              rel_pos_temporal=True, residual_pooling=True, dim_mul_in_att=dim_mul_in_att)
    jmod = jattn.MultiScaleBlock(dim=8, dim_out=16, input_size=thw, **kw)
    tmod = tattn.MultiScaleBlock(8, 16, input_size=thw, **kw)
    params = jax.device_get(jax.jit(lambda: jmod.init(jax.random.PRNGKey(4), jnp.asarray(x), thw))())["params"]

    def jloss(p, xx):
        out = jmod.apply({"params": p}, xx, thw)
        return jnp.sum(out[0] * jnp.sin(out[0])), out

    (_, out_j), (gp, gx) = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(params, jnp.asarray(x))
    tmod.load_state_dict(params_to_torch(params))
    assert tmod.attn.dim_out == (16 if dim_mul_in_att else 8)
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmod(xt, thw)
    torch.sum(out_t[0] * torch.sin(out_t[0])).backward()
    assert tuple(out_t[1]) == tuple(out_j[1])
    assert rel_err(out_t[0].detach().numpy(), out_j[0]) <= 1e-5
    assert rel_err(xt.grad.numpy(), gx) <= 1e-5
    grads = {name: p.grad.numpy() for name, p in tmod.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(gp)), 1e-5)


@pytest.mark.parametrize("over", [V2, {"MVIT.USE_FIXED_SINCOS_POS": True, "MVIT.EMBED_DIM": 32},
                                  {**V2, "MVIT.CLS_EMBED_ON": False}],
                         ids=["v2", "fixed_sincos", "v2_no_cls"])
def test_mvit_v2_matches_jax(over):
    """The MViTv2 classifier of tests/test_transformers.py:61-71 (rel-pos in
    space and time, residual pooling, DIM_MUL_IN_ATT; two Q-pooling blocks
    that double the width, the cls token), with TPU.FLASH_ATTENTION asked
    for, which rel-pos turns off; and the same tiny MViT with the fixed
    sin-cos table (32 wide: its spatial halves need an even width): logits
    and every gradient of sum(tanh(logits))."""
    jcfg = jconfig.assert_and_infer_cfg(_mvit_cfg(**{"MVIT.DROPPATH_RATE": 0.0, "TPU.FLASH_ATTENTION": True,
                                                     **over}))
    tcfg = _port_cfg(jcfg)
    jm = jbuild_model(jcfg, sync_axes=())
    x = np.random.default_rng(6).standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))()["params"])

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(jnp.tanh(out)), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = build_model(tcfg, "cpu")
    rel = bool(tcfg.MVIT.REL_POS_SPATIAL)
    assert all(getattr(tm, f"blocks_{i}").attn.flash != rel for i in range(4))
    tm.load_state_dict(params_to_torch(params))
    tm.train()
    launches = fa.flash_mha_fwd.launches
    out_t = tm(torch.from_numpy(x))
    torch.sum(torch.tanh(out_t)).backward()
    if rel:
        assert fa.flash_mha_fwd.launches == launches
    assert rel_err(out_t.detach().numpy(), out_j) <= 1e-4
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(g_j)), 1e-4)
    # AdamW with ZERO_WD_1D_PARAM: labels and weight decay as JAX's, the
    # relative position tables undecayed
    for c in (jcfg, tcfg):
        c.SOLVER.OPTIMIZING_METHOD, c.SOLVER.WEIGHT_DECAY, c.SOLVER.ZERO_WD_1D_PARAM = "adamw", 0.05, True
    assert not optimizer_masks_disagree(jcfg, tcfg, params, tm)
    if rel:
        wd = topt.wd_tree(tcfg, dict(tm.named_parameters()))
        assert wd["blocks_1.attn.rel_pos_h"] == wd["blocks_1.attn.rel_pos_t"] == 0.0


def test_reversible_mvit_v2_matches_jax():
    """The reversible MViT (REV with O1_SCAN: uniform segments of 1 and 3
    blocks, two transitions) with rel-pos in space and time and residual
    pooling in every attention, the transitions' included: logits and every
    gradient of sum(tanh(logits)), drop path 0."""
    over = {"MODEL.MODEL_NAME": "MViT", "MODEL.NUM_CLASSES": 5, "MODEL.HEAD_ACT": "none",
            "MVIT.REL_POS_SPATIAL": True, "MVIT.REL_POS_TEMPORAL": True, "MVIT.RESIDUAL_POOLING": True}
    jcfg, tcfg = masked_cfg(jconfig, **over), masked_cfg(tconfig, **over)
    jm = jbuild_model(jcfg, sync_axes=())
    x = np.random.default_rng(3).standard_normal((2, 4, 28, 28, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False))()["params"])

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.sum(jnp.tanh(out)), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = build_model(tcfg, "cpu")
    assert not tm.rev_seg1_f[0].attn.flash and hasattr(tm.blocks_2.attn, "rel_pos_t")
    tm.load_state_dict(params_to_torch(params))
    tm.train()
    out_t = tm(torch.from_numpy(x))
    torch.sum(torch.tanh(out_t)).backward()
    assert rel_err(out_t.detach().numpy(), out_j) <= 1e-4
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(g_j)), 1e-4)


@pytest.mark.parametrize("knob,value,item", [
    ("MVIT.POOL_FIRST", True, None), ("MVIT.MODE", "max", None), ("MVIT.SEPARATE_QKV", True, None),
    ("MVIT.LAYER_SCALE_INIT_VALUE", 0.1, None), ("MVIT.DROPOUT_RATE", 0.1, None),
    ("MVIT.NORM_STEM", True, None), ("MVIT.PATCH_2D", True, None), ("MVIT.HEAD_INIT_SCALE", 0.5, None),
    ("TPU.MESH_PIPE", 2, None),
])
def test_check_ported_names_what_is_left(knob, value, item):
    """Nothing is left: the trainer's gate passes the A 20 knobs, the
    MViTv2 options, the fixed sin-cos table, SCALE_INIT_BY_DEPTH and
    TPU.MESH_PIPE (GPipe, tests/test_torch_pipeline.py)."""
    cfg = _port_cfg(_mvit_cfg())
    check_ported(_port_cfg(_mvit_cfg(**V2, **{"MVIT.USE_FIXED_SINCOS_POS": True, "MASK.ENABLE": True,
                                              "MASK.SCALE_INIT_BY_DEPTH": True})))
    _override(cfg, {knob: value})
    if item is None:
        check_ported(cfg)
        return
    with pytest.raises(NotImplementedError, match=f"{knob.split('.')[1]}.*ROADMAP {item}"):
        check_ported(cfg)


def _mvit_s_cfg(mod):
    """configs/pretrain/MViT_S_rev_masked.yaml (the plain encoder, HOG
    targets, loader masks, REMAT, AdamW with CLIP_GRAD_NORM 0.02) at a
    reduced MViT-S: width 8, 6 blocks with the preset's doubling and Q
    pooling at blocks 1 and 3 (its third stage at 14 cut), KV strides
    adaptive from [1, 8, 8]; 4 frames at 32^2 (a 2 x 8 x 8 grid pooled to 2
    x 2 x 2: 16 px tokens, 2 x 2 HOG cells of 8 px), one card, 2 videos,
    no drop path, float32."""
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/MViT_S_rev_masked.yaml")
    _override(cfg, {"NUM_GPUS": 1, "NUM_WORLDS": 1, "TPU.MESH_SYNC": 1, "TPU.COMPUTE_DTYPE": "float32",
                    "TPU.DONATE": False, "MVIT.EMBED_DIM": 8, "MVIT.DEPTH": 6,
                    "MVIT.DIM_MUL": [[1, 2.0], [3, 2.0]], "MVIT.HEAD_MUL": [[1, 2.0], [3, 2.0]],
                    "MVIT.POOL_Q_STRIDE": [[1, 1, 2, 2], [3, 1, 2, 2]], "MVIT.DROPPATH_RATE": 0.0,
                    "MASK.PRETRAIN_DEPTH": [5], "DATA.NUM_FRAMES": 4, "DATA.TRAIN_CROP_SIZE": 32,
                    "DATA.TEST_CROP_SIZE": 32, "AUG.TARGET_SIZE": 32, "DATA.BATCHSIZE_PER_GPU": 2})
    return mod.assert_and_infer_cfg(cfg)


def test_mvit_s_masked_step_trajectory_matches_jax():
    """Three steps of the MViT-S MaskFeat preset cut to size, with the
    loader's block masks and the aug held apart: losses, grad norms, params
    and Adam's moments."""
    jcfg, tcfg = _mvit_s_cfg(jconfig), _mvit_s_cfg(tconfig)
    assert tcfg.TPU.REMAT and not tcfg.MVIT.REV.ENABLE and tcfg.MASK.PRED_HOG
    params = model_variables(jbuild_model(jcfg, sync_axes=()), 4, 32)
    mesh = build_mesh(jcfg, jax.devices()[:1])
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats={}, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl={}), mesh)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    tm = build_model(tcfg, "cpu")
    tm.load_state_dict(params_to_torch(params))
    tp = dict(tm.named_parameters())
    tbundle = build_tx(tcfg, tp)
    tstate = TrainState(tm, tbundle.tx.init(tp), 0)
    tstep = make_train_step(tcfg, tbundle, None)
    for i in range(STEPS):
        clips = np.random.default_rng(300 + i).standard_normal((2, 1, 4, 32, 32, 3)).astype(np.float32)
        masks = loader_masks(tcfg, 2, seed=i).reshape(2, 1, 2, 8, 8)
        jstate, jst = jstep(jstate, jnp.asarray(clips), {"mask": jnp.asarray(masks)}, jax.random.PRNGKey(i),
                            jnp.float32(LR))
        tst = tstep(tstate, torch.from_numpy(clips), {"mask": torch.from_numpy(masks)}, None, LR)
        assert float(tst["loss_mask"]) == pytest.approx(float(jst["loss_mask"]), rel=1e-4), i
        assert float(tst["grad_norm"]) == pytest.approx(float(jst["grad_norm"]), rel=1e-3), i
    jstate = jax.device_get(jstate)
    adam = [s for s in jstate.opt_state if hasattr(s, "mu")][0]
    assert tstate.step == int(jstate.step) == STEPS
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
