"""The port's Video Swin (advise_tpu_torch/models/swin3d.py) against the JAX
package's (advise_tpu/models/swin3d.py), with the JAX initial variables
passed through the param bridge (advise_tpu_torch/utils/convert.py).

The small Swin: embed 24, depths (2, 2, 2), heads (2, 4, 8), window (2, 4,
4), patch (2, 4, 4) on 6 frames x 40^2, a grid of (3, 10, 10). Stage 1
pads the grid to (4, 12, 12) and shifts by (1, 2, 2); PatchMerging pads
5 -> 6 on its way to stage 3, whose (3, 3, 3) grid clamps the window to (2,
3, 3) and the shift to (1, 0, 0). So padding, shift and clamping all fire.

Tolerances: the helpers are EQUAL to JAX's. Float32 outputs agree to 1e-5
of their largest magnitude (measured 5.1e-7) and the parameter gradients
to 1e-4 of each tensor's largest (``grads_agree``: float32 sums in other
orders; measured <= 2.2e-6). The bf16 forward (Flax ``dtype=bf16``: bf16
Dense and conv, float32 LayerNorm statistics, float32 scores and softmax)
agrees with JAX's bf16 forward to 3e-2 of the largest logit (bf16 keeps 8
bits; the two sides round their sums differently through 6 blocks;
measured 9.6e-3). REMAT on is EQUAL to REMAT off.

The Swin-B MoCo preset is built on the meta device (no weights drawn) and
its tree held name for name and shape for shape to JAX's ``eval_shape``
through the converter, with the optimizer's masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models import swin3d as jswin
from advise_tpu.solver import optimizer as jopt
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models import swin3d as tswin
from advise_tpu_torch.models.contrastive import ContrastiveModel
from advise_tpu_torch.models.layers.norm import get_norm
from advise_tpu_torch.solver import optimizer as topt
from advise_tpu_torch.utils.convert import _flatten, _param_leaf, batch_stats_to_torch, param_key, params_to_torch

from torch_port_common import _override, grads_agree, rel_err

torch.set_num_threads(1)

T, S = 6, 40
SMALL = {"SWIN.EMBED_DIM": 24, "SWIN.DEPTHS": [2, 2, 2], "SWIN.NUM_HEADS": [2, 4, 8],
         "SWIN.WINDOW_SIZE": [2, 4, 4], "SWIN.PATCH_SIZE": [2, 4, 4], "SWIN.DROP_PATH_RATE": 0.0}
SWIN_B = "configs/pretrain/SwinB_moco_32chips.yaml"
SWIN_B_PARAMS = 90_002_504  # the JAX package's eval_shape of the preset


def swin_cfg(mod, **overrides):
    """MODEL_NAME SwinTransformer3D (a classification Dense of 5 classes)
    at the small size, float32, one device."""
    cfg = mod.get_cfg()
    cfg.MODEL.MODEL_NAME = "SwinTransformer3D"
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.HEAD_ACT = "none"
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.DATA.NUM_FRAMES = T
    cfg.AUG.TARGET_SIZE = S
    _override(cfg, {**SMALL, **overrides})
    return mod.assert_and_infer_cfg(cfg)


@pytest.fixture(scope="module")
def small():
    jcfg = swin_cfg(jconfig)
    jm = jbuild_model(jcfg, sync_axes=())
    params = jax.device_get(jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, T, S, S, 3), jnp.float32), train=False))()["params"])
    x = np.random.default_rng(0).standard_normal((2, T, S, S, 3)).astype(np.float32)
    return jcfg, jm, params, x


def _port(params, **overrides):
    model = build_model(swin_cfg(tconfig, **overrides), "cpu")
    sd = params_to_torch(params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    return model


def test_helpers_equal_jax():
    """window_partition / window_reverse, get_window_size, compute_mask and
    _rel_pos_index exactly equal to JAX's, over geometries with and without
    shift and padding."""
    rng = np.random.default_rng(1)
    for shape, ws in (((2, 4, 8, 8, 3), (2, 4, 4)), ((1, 8, 14, 14, 5), (8, 7, 7)), ((3, 2, 6, 9, 2), (1, 3, 3))):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jswin.window_partition(jnp.asarray(x), ws))
        got = tswin.window_partition(torch.from_numpy(x), ws)
        np.testing.assert_array_equal(got.numpy(), want)
        back = tswin.window_reverse(got, ws, *shape[:4])
        np.testing.assert_array_equal(back.numpy(), np.asarray(jswin.window_reverse(jnp.asarray(want), ws, *shape[:4])))
        np.testing.assert_array_equal(back.numpy(), x)
    for size, ws, shift in (((3, 10, 10), (2, 4, 4), (1, 2, 2)), ((3, 3, 3), (2, 4, 4), (1, 2, 2)),
                            ((8, 56, 56), (8, 7, 7), (4, 3, 3)), ((8, 7, 7), (8, 7, 7), (4, 3, 3)),
                            ((8, 14, 14), (4, 7, 7), (2, 3, 3)), ((2, 2, 2), (4, 7, 7), None)):
        assert tswin.get_window_size(size, ws, shift) == jswin.get_window_size(size, ws, shift)
    for geo, ws, shift in (((4, 12, 12), (2, 4, 4), (1, 2, 2)), ((4, 8, 8), (2, 4, 4), (0, 2, 2)),
                           ((4, 8, 8), (2, 4, 4), (1, 0, 0)), ((4, 8, 8), (2, 4, 4), (0, 0, 0)),
                           ((8, 14, 14), (4, 7, 7), (2, 3, 3)), ((2, 8, 8), (2, 4, 4), (0, 0, 2))):
        want = jswin.compute_mask(*geo, ws, shift)
        got = tswin.compute_mask(*geo, ws, shift)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for ws in ((2, 4, 4), (2, 3, 3), (8, 7, 7), (4, 7, 7), (1, 1, 1)):
        np.testing.assert_array_equal(tswin._rel_pos_index(ws), jswin._rel_pos_index(ws))


def test_small_swin_forward_and_grads_match_jax(small):
    """The float32 forward in evaluation and training (no drop path), and the
    parameter gradients of sum(logits * w) in training."""
    jcfg, jm, params, x = small
    model = _port(params)
    w = np.random.default_rng(2).standard_normal((2, 5)).astype(np.float32)
    for train in (False, True):
        want = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=train))(params, jnp.asarray(x))
        with torch.no_grad():
            got = model.train(train)(torch.from_numpy(x))
        assert tuple(got.shape) == (2, 5)
        assert rel_err(got.numpy(), want) <= 1e-5, (train, rel_err(got.numpy(), want))

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x, train=True) * w)

    g_j = params_to_torch(jax.device_get(jax.jit(jax.grad(loss))(params, jnp.asarray(x))))
    model.train()
    model.zero_grad()
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    g_t = {n: p.grad for n, p in model.named_parameters()}
    bad = grads_agree(g_t, g_j, 1e-4)
    assert not bad, bad


def test_small_swin_bf16_forward_matches_jax(small):
    """Flax dtype bf16 against the port's bf16 model under the step's
    autocast, the same float32 parameters."""
    _, _, params, x = small
    jm = jbuild_model(swin_cfg(jconfig, **{"TPU.COMPUTE_DTYPE": "bfloat16"}), sync_axes=())
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))(params, jnp.asarray(x, jnp.bfloat16))
    model = _port(params, **{"TPU.COMPUTE_DTYPE": "bfloat16"}).eval()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) <= 3e-2


def test_drop_path_two_masks_per_block_and_remat_replays_them(small):
    """Drop path 0.3: each block draws two keep masks (attention, MLP) from
    the step's generator before any block runs, the first block's rate is 0
    (no draw); REMAT on gives the same outputs and gradients, bit for bit,
    as REMAT off from the same generator, so the recomputation replays the
    masks."""
    _, _, params, x = small
    runs = []
    for remat in (False, True):
        model = _port(params, **{"SWIN.DROP_PATH_RATE": 0.3, "TPU.REMAT": remat}).train()
        keeps = model.keeps(8, torch.Generator().manual_seed(3))
        assert [len(k) for k in keeps] == [2, 2, 2] and all(len(pair) == 2 for k in keeps for pair in k)
        assert keeps[0][0] == (None, None)
        drawn = [pair for k in keeps for pair in k][1:]
        assert all(a is not None and b is not None for a, b in drawn)
        assert any(not torch.equal(a, b) for a, b in drawn)  # two masks, not one used twice
        out = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(4))
        out.square().sum().backward()
        runs.append((out.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (o0, g0), (o1, g1) = runs
    assert torch.equal(o0, o1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    with torch.no_grad():
        assert not torch.equal(o0, model.eval()(torch.from_numpy(x)))


def test_forward_outside_the_built_geometry_raises(small):
    """A grid that clamps a window to another size than the table's raises
    (Flax's apply fails on the table's shape)."""
    _, _, params, _ = small
    model = _port(params).eval()
    with pytest.raises(ValueError, match="bias table"):
        model(torch.zeros(1, T, 64, 64, 3))


def _swin_b_cfg(mod):
    cfg = mod.get_cfg()
    cfg.merge_from_file(SWIN_B)
    cfg.NUM_GPUS = 1
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    return mod.assert_and_infer_cfg(cfg)


@pytest.fixture(scope="module")
def swin_b():
    """JAX's Swin-B MoCo tree by eval_shape; the port's model on meta."""
    jcfg, tcfg = _swin_b_cfg(jconfig), _swin_b_cfg(tconfig)
    jm = jbuild_model(jcfg, sync_axes=())
    t, s = jcfg.DATA.NUM_FRAMES, jcfg.AUG.TARGET_SIZE
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                            jnp.zeros((1, t, s, s, 3), jnp.float32), train=False))
    with torch.device("meta"):
        model = ContrastiveModel(tcfg, get_norm(tcfg), torch.bfloat16)
    return jcfg, tcfg, shapes, model


def _torch_shapes(tree):
    """{torch param name: shape} of a Flax tree of ShapeDtypeStructs through
    the converter's names and layouts."""
    return {param_key(p): tuple(_param_leaf(p, np.broadcast_to(np.float32(0), leaf.shape)).shape)
            for p, leaf in _flatten(tree)}


def test_swin_b_tree_matches_jax(swin_b):
    """90,002,504 parameters and 4,096 batch statistics, name for name and
    shape for shape."""
    _, _, shapes, model = swin_b
    want = _torch_shapes(shapes["params"])
    want_bs = {k: tuple(v.shape) for k, v in batch_stats_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])).items()}
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got_bs = {n: tuple(b.shape) for n, b in model.named_buffers()}
    assert got == want
    assert got_bs == want_bs
    assert sum(int(np.prod(s)) for s in got.values()) == SWIN_B_PARAMS
    assert sum(int(np.prod(s)) for s in got_bs.values()) == 4096
    assert set(model.state_dict()) == set(want) | set(want_bs)


def test_swin_b_optimizer_masks_match_jax(swin_b):
    """Under ZERO_WD_1D_PARAM (LARS-SGD): the labels, the weight decay and
    the LARS mask (ndim > 1) of every parameter equal JAX's, the 2-D
    relative position tables decayed and under LARS, the LayerNorms, biases
    and bn0 not."""
    jcfg, tcfg, shapes, model = swin_b
    params = dict(model.named_parameters())
    j_labels = {param_key(p): v for p, v in _flatten(jopt.classify_params(jcfg, shapes["params"]))}
    j_wd = {param_key(p): v for p, v in _flatten(jopt.wd_tree(jcfg, shapes["params"]))}
    j_ndim = {param_key(p): len(leaf.shape) for p, leaf in _flatten(shapes["params"])}
    assert set(j_labels) == set(j_ndim) == set(params)
    t_labels = topt.classify_params(tcfg, params)
    t_wd = topt.wd_tree(tcfg, params)
    for n, p in params.items():
        assert t_labels[n] == j_labels[n], n
        assert t_wd[n] == pytest.approx(j_wd[n]), n
        assert (p.ndim > 1) == (j_ndim[n] > 1), n
    table = "backbone.layers_2.blocks_0.attn.relative_position_bias_table"
    assert t_labels[table] == "default" and params[table].ndim == 2
    assert t_labels["backbone.head.projection.bn0.weight"] == "bn"
    assert t_labels["backbone.layers_0.blocks_0.norm1.weight"] == "one_d"
    assert tcfg.SOLVER.LARS_ON and tcfg.SOLVER.ZERO_WD_1D_PARAM
