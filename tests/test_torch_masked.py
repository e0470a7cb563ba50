"""The port's MaskFeat slice (advise_tpu_torch/models/masked.py,
layers/operators.py, data/masking.py, the OnlyCrop aug, AdamW and the masked
train step) against the JAX package's, on the tiny MViT-L joint
configuration of ``torch_port_common.masked_cfg`` (REV with O1_SCAN, HOG
targets, joint NT-Xent, flash on; loader masks injected).

JAX runs its flash attention interpreted for the forward; for gradients it
runs its dense chain, because the reversible walk's transitions always run
under ``nn.remat`` and JAX cannot differentiate the interpreted Pallas kernel
there (tests/test_flash_attention.py holds JAX's flash to its dense chain at
1e-5). Tolerances (float32): HOG features and labels 1e-5 of their largest
value, the OnlyCrop output 1e-4 absolute after normalisation (its two
einsums contract in another order than JAX's one; values are O(1)), the
model's outputs, loss and gradients 1e-4 (``grads_agree``). The trajectory
test follows tests/test_torch_step.py: a small lr (1e-4), and what each
tensor moved held to 5e-2 of JAX's move plus 1e-6 of the tree's largest
value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu import config as jconfig
from advise_tpu.data.device_aug import make_rrc_aug as jmake_rrc_aug
from advise_tpu.data.device_aug import sample_rrc_box as jsample_rrc_box
from advise_tpu.data.masking import MaskingGenerator3D as JMaskingGenerator3D
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.engine.steps import masked_task_loss as jmasked_task_loss
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models.layers.operators import hog_features as jhog
from advise_tpu.models.masked import hog_label_3d as jhog_label
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.data import build_device_aug, ingest_geometry
from advise_tpu_torch.data.masking import MaskingGenerator3D, build_mask_generator
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_train_step, masked_task_loss
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.operators import hog_features
from advise_tpu_torch.models.masked import hog_label_3d, pad_frames_edge
from advise_tpu_torch.ops import flash_attention as fa
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import params_to_torch

from torch_port_common import (
    MASK_B, MASK_K, MASK_S, MASK_T, grads_agree, loader_masks, masked_cfg,
    masked_variables, on_mesh, rel_err,
)

torch.set_num_threads(1)

LR = float(np.float32(1e-4))
STEPS = 3


@pytest.mark.parametrize("size,cell", [(32, 4), (24, 8)])
def test_hog_features_match_jax(size, cell):
    x = np.random.default_rng(0).uniform(-2, 2, (3, size, size, 3)).astype(np.float32)
    want = np.asarray(jhog(jnp.asarray(x), nbins=9, cell_sz=cell))
    got = hog_features(torch.from_numpy(x), nbins=9, cell_sz=cell).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("size,need,feat_hw", [(28, 32, 4), (32, 32, 4)])
def test_hog_label_matches_jax(size, need, feat_hw):
    """[B, T, S, S, 3] frames edge-padded to ``need`` (28 -> 32: the tokens of
    a non-tiling grid), then per-token HOG with 2 x 2 cells of 4 px."""
    fr = np.random.default_rng(1).uniform(-2, 2, (2, 2, size, size, 3)).astype(np.float32)
    lo = (need - size) // 2
    padded = jnp.pad(jnp.asarray(fr), ((0, 0), (0, 0), (lo, need - size - lo),
                                       (lo, need - size - lo), (0, 0)), mode="edge")
    want = np.asarray(jhog_label(padded, feat_hw, 9, 4))
    got = hog_label_3d(pad_frames_edge(torch.from_numpy(fr), need), feat_hw, 9, 4).numpy()
    assert got.shape == want.shape == (2, 2 * feat_hw * feat_hw, 3 * 9 * (need // feat_hw // 4) ** 2)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("grid,ratio,max_patches", [((2, 7, 7), 0.4, None), ((16, 78, 78), 0.4, None),
                                                    ((4, 14, 14), 0.6, 20)])
def test_masking_generator_matches_jax(grid, ratio, max_patches):
    total = grid[0] * grid[1] * grid[2]
    kw = dict(max_num_patches=max_patches)
    jgen = JMaskingGenerator3D(grid, int(round(ratio * total)), **kw)
    tgen = MaskingGenerator3D(grid, int(round(ratio * total)), **kw)
    for seed in range(3):
        want = jgen(np.random.default_rng(seed))
        got = tgen(np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mask_generator_uses_the_loader_grid():
    cfg = masked_cfg(tconfig)
    masks = loader_masks(cfg, 4)
    assert masks.shape == (4, MASK_T // 2, MASK_S // 4, MASK_S // 4)
    gen = build_mask_generator(cfg)
    assert gen.num_masking_patches == int(round(0.4 * masks[0].size)) // (MASK_T // 2)
    assert 0 < masks.mean() < 1


def test_onlycrop_matches_jax():
    """The port's OnlyCrop apply, fed JAX's own RandomResizedCrop boxes (the
    key splits of make_rrc_aug), against JAX's make_rrc_aug under jit (the
    program the train step runs)."""
    jcfg, tcfg = masked_cfg(jconfig), masked_cfg(tconfig)
    assert tcfg.AUG.TYPE == "OnlyCrop"
    w, h = ingest_geometry(tcfg, "train")
    batch = np.random.default_rng(2).integers(0, 256, (MASK_B, MASK_K, MASK_T, h, w, 3),
                                              dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(jmake_rrc_aug(jcfg, scale=(jcfg.AUG.MIN_AREA, 1.0)))(jnp.asarray(batch), key))
    keys = jax.random.split(key, MASK_B * MASK_K)
    boxes = np.array([[float(v) for v in jsample_rrc_box(
        jax.random.split(kk)[0], h, w, (jcfg.AUG.MIN_AREA, 1.0), tuple(jcfg.AUG.RAND_CROP_RATIO))]
        for kk in keys], np.float32)
    assert len({tuple(b) for b in boxes}) == len(boxes)  # the clips crop differently
    aug = build_device_aug(tcfg, "train")
    got = aug.apply(torch.from_numpy(batch), {"box": torch.from_numpy(boxes)}).numpy()
    assert got.shape == want.shape == (MASK_B, MASK_K, MASK_T, MASK_S, MASK_S, 3)
    assert float(np.abs(got - want).max()) <= 1e-4


@pytest.fixture(scope="module")
def masked_models():
    jcfg, tcfg = masked_cfg(jconfig), masked_cfg(tconfig)
    params = masked_variables(jbuild_model(jcfg, sync_axes=()))
    return jcfg, tcfg, params


def _clips(i):
    rng = np.random.default_rng(100 + i)
    return rng.standard_normal((MASK_B, MASK_K, MASK_T, MASK_S, MASK_S, 3)).astype(np.float32)


def _masks(cfg, i):
    m = loader_masks(cfg, MASK_B * MASK_K, seed=i)
    return m.reshape(MASK_B, MASK_K, *m.shape[1:])


def test_maskmvit_loss_and_grads_match_jax(masked_models):
    """MaskMViT (REV, HOG, joint) in training with the loader masks: the
    predictions, labels, pooled masks and projection against JAX's
    interpreted-flash forward, and the masked + NT-Xent loss and every
    parameter gradient against JAX's masked_task_loss."""
    jcfg, tcfg, params = masked_models
    clips, masks = _clips(0), _masks(tcfg, 0)
    n = MASK_B * MASK_K
    x = jnp.asarray(clips.reshape(n, *clips.shape[2:]))
    lm = jnp.asarray(masks.reshape(n, -1))
    jm = jbuild_model(jcfg, sync_axes=())
    rngs = {"dropout": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}
    with pltpu.force_tpu_interpret_mode():
        out_j = jax.jit(lambda p: jm.apply({"params": p}, x, train=True, rngs=rngs,
                                           loader_mask=lm))(params)
    dense = jcfg.clone()
    dense.TPU.FLASH_ATTENTION = False
    jd = jbuild_model(dense, sync_axes=())

    def jloss(p):
        # train=False: outside a mesh (no all_gather); with drop path 0 the
        # forward is the training one
        loss, (_, stats) = jmasked_task_loss(dense, jd, p, {}, jnp.asarray(clips),
                                             {"mask": jnp.asarray(masks)}, jax.random.PRNGKey(0),
                                             train=False)
        return loss, stats

    (loss_j, stats_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    tm = build_model(tcfg, "cpu")
    tm.load_state_dict(params_to_torch(params))
    tm.train()
    out_t = tm(torch.from_numpy(clips.reshape(n, *clips.shape[2:])),
               loader_mask=torch.from_numpy(masks.reshape(n, -1)))
    for name, a, b in (("pred", out_t[0][0], out_j[0][0]), ("label", out_t[1][0], out_j[1][0]),
                       ("mask", out_t[2][0], out_j[2][0]), ("proj", out_t[4], out_j[4])):
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel_err(a.detach().numpy(), b) <= 1e-4, name
    assert out_t[2][0].shape == (n, 2 * 4 * 4) and 0 < float(out_t[2][0].mean()) < 1

    loss_t, stats_t = masked_task_loss(tcfg, tm, torch.from_numpy(clips),
                                       {"mask": torch.from_numpy(masks)}, None)
    assert set(stats_t) == set(stats_j) == {"loss_mask", "loss_nce", "loss_total"}
    for k in stats_t:
        assert float(stats_t[k].detach()) == pytest.approx(float(stats_j[k]), rel=1e-4), k
    params_t = dict(tm.named_parameters())
    grads = dict(zip(params_t, (g.numpy() for g in torch.autograd.grad(loss_t, list(params_t.values())))))
    assert not grads_agree(grads, params_to_torch(jax.device_get(g_j)), 1e-4)


def _moved_err(got, want, init, top):
    got, want, init = (np.asarray(a, np.float32) for a in (got, want, init))
    bound = 5e-2 * np.abs(want - init).max() + 1e-6 * top
    return float(np.abs(got - want).max()), float(bound)


def test_masked_step_trajectory_matches_jax(masked_models):
    """Three masked steps (AdamW with CLIP_GRAD_NORM 0.02 and weight decay
    0.05 in the preset's groups, aug held apart) from the same initial
    params: losses, grad norms, params and Adam's moments."""
    jcfg, tcfg, params = masked_models
    dense = jcfg.clone()
    dense.TPU.FLASH_ATTENTION = False  # differentiable under the transitions' remat
    mesh = build_mesh(dense, jax.devices()[:1])
    bundle = jbuild_tx(dense, params)
    jstate = on_mesh(JState(params=params, batch_stats={}, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl={}), mesh)
    jstep = jmake_step(dense, mesh, jbuild_model(dense), bundle, None)

    tm = build_model(tcfg, "cpu")
    tm.load_state_dict(params_to_torch(params))
    tp = dict(tm.named_parameters())
    tbundle = build_tx(tcfg, tp)
    tstate = TrainState(tm, tbundle.tx.init(tp), 0)
    tstep = make_train_step(tcfg, tbundle, None)
    for i in range(STEPS):
        clips, masks = _clips(i), _masks(tcfg, i)
        jstate, jstats = jstep(jstate, jnp.asarray(clips), {"mask": jnp.asarray(masks)},
                               jax.random.PRNGKey(i), jnp.float32(LR))
        tstats = tstep(tstate, torch.from_numpy(clips), {"mask": torch.from_numpy(masks)}, None, LR)
        for k in ("loss_mask", "loss_nce", "loss_total"):
            assert float(tstats[k]) == pytest.approx(float(jstats[k]), rel=1e-4), (i, k)
        assert float(tstats["grad_norm"]) == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
        assert float(jstats["grad_norm"]) > tcfg.SOLVER.CLIP_GRAD_NORM  # the clip acts
    assert tstate.step == int(jstate.step) == STEPS
    jstate = jax.device_get(jstate)
    adam = [s for s in jstate.opt_state if hasattr(s, "mu")][0]
    assert tstate.opt_state["count"] == int(adam.count) == STEPS
    p0 = params_to_torch(params)
    zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
    own = tm.state_dict()
    for got, want, init in ((own, params_to_torch(jstate.params), p0),
                            (tstate.opt_state["mu"], params_to_torch(adam.mu), zeros),
                            (tstate.opt_state["nu"], params_to_torch(adam.nu), zeros)):
        top = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            err, bound = _moved_err(got[k].detach(), v, init[k], top)
            assert err <= bound, (k, err, bound)


def test_masked_step_with_onlycrop_and_drop_path_on_cpu():
    """The whole slice at the tiny size: uint8 clips at the OnlyCrop ingest
    geometry, loader masks from the port's generator, drop path 0.3 (the
    preset's), two steps; finite losses and grad norm, parameters moved, and
    no kernel launch on the CPU."""
    tcfg = masked_cfg(tconfig, **{"MVIT.DROPPATH_RATE": 0.3})
    w, h = ingest_geometry(tcfg, "train")
    model = build_model(tcfg, "cpu")
    params = dict(model.named_parameters())
    before = {k: v.detach().clone() for k, v in params.items()}
    bundle = build_tx(tcfg, params)
    state = TrainState(model, bundle.tx.init(params), 0)
    step = make_train_step(tcfg, bundle, build_device_aug(tcfg, "train"))
    gen = torch.Generator().manual_seed(0)
    clips = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (MASK_B, MASK_K, MASK_T, h, w, 3), dtype=np.uint8))
    launches = (fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches)
    for i in range(2):
        stats = step(state, clips, {"mask": torch.from_numpy(_masks(tcfg, i))}, gen, LR)
        assert all(bool(torch.isfinite(v)) for v in stats.values()), stats
    assert state.step == 2
    assert all(not torch.equal(before[k], v) for k, v in params.items() if "norm_k.bias" not in k)
    assert (fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches) == launches
