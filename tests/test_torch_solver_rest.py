"""The rest of the port's solver (advise_tpu_torch/solver) against the JAX
package's: the steps_with_relative_lrs policy, the 'adam' chain, LARS over
AdamW and over Adam (optimizer.Adam) against optax's chains of
``advise_tpu/solver/optimizer.py build_tx``, and SOLVER.LAYER_DECAY's
per-parameter lr scales against ``layer_decay_scales`` on the JAX trees of
a reduced reversible MViT-S MaskFeat model and of the MAE model.

Tolerances: the lr policy equal; the directions 1e-6 of each tensor's
largest value over 3 steps (float32, the same operations in the same
order); the scales equal.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.solver import lr_policy as jlr
from advise_tpu.solver import optimizer as jopt
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.models import MODEL_REGISTRY, compute_dtype
from advise_tpu_torch.models.layers.norm import get_norm
from advise_tpu_torch.solver import lr_policy as tlr
from advise_tpu_torch.solver import optimizer as topt
from advise_tpu_torch.utils.convert import param_key, params_to_torch

from torch_port_common import MAE_S, MAE_T, _override, mae_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("warmup", [0.0, 5.0])
def test_steps_with_relative_lrs_matches_jax(warmup):
    """LRS[i] * BASE_LR in step i of STEPS, under the linear warm-up, at 37
    epochs from 0 to MAX_EPOCH (its steps' boundaries among them)."""
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_cfg()
        _override(cfg, {"SOLVER.LR_POLICY": "steps_with_relative_lrs", "SOLVER.BASE_LR": 0.4,
                        "SOLVER.STEPS": [0, 20, 30], "SOLVER.LRS": [1.0, 0.1, 0.01],
                        "SOLVER.MAX_EPOCH": 36, "SOLVER.WARMUP_EPOCHS": warmup,
                        "SOLVER.WARMUP_START_LR": 0.01})
        cfgs.append(cfg)
    epochs = [float(e) for e in np.linspace(0.0, 36.0, 37)]
    got = [tlr.get_lr_at_epoch(cfgs[1], e) for e in epochs]
    assert got == [jlr.get_lr_at_epoch(cfgs[0], e) for e in epochs]
    assert got[20] == pytest.approx(0.04) and got[19] == pytest.approx(0.4 if warmup < 19 else got[19])
    assert got[30] == pytest.approx(0.004)
    assert [tlr.get_step_index(cfgs[1], e) for e in (0.0, 19.9, 20.0, 35.0)] == [0, 0, 1, 2]


def _tree(seed=0):
    """A parameter tree with blocks, a head, 1-D parameters and a zero
    kernel (LARS's ratio 1 where a norm is 0)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"blocks_0": {"attn": {"qkv": {"kernel": r(8, 24), "bias": r(24)}}, "norm1": {"scale": r(8) + 1}},
            "blocks_1": {"mlp": {"fc1": {"kernel": r(8, 16), "bias": r(16)}}},
            "patch_embed": {"proj": {"kernel": r(3, 3, 3, 3, 8)}},
            "head": {"projection": {"kernel": r(8, 4)}},
            "zero": {"kernel": np.zeros((3, 3), np.float32)}}


CHAINS = [("adam", False, 0.0), ("adamw", True, 0.0), ("adam", True, 0.0), ("adamw", True, 1.0)]


@pytest.mark.parametrize("method,lars,clip", CHAINS)
def test_adam_chains_match_optax(method, lars, clip):
    """'adam' (coupled weight decay, then Adam), LARS over AdamW (Adam, the
    masked trust ratio, + wd * p) and over Adam (wd, trust ratio, Adam),
    with and without clipping: the directions of 3 steps from random
    gradients, and Adam's count."""
    over = {"SOLVER.OPTIMIZING_METHOD": method, "SOLVER.LARS_ON": lars, "SOLVER.CLIP_GRAD_NORM": clip,
            "SOLVER.WEIGHT_DECAY": 0.05, "SOLVER.ZERO_WD_1D_PARAM": True, "SOLVER.BETAS": [0.9, 0.95]}
    jcfg, tcfg = jconfig.get_cfg(), tconfig.get_cfg()
    _override(jcfg, over)
    _override(tcfg, over)
    tree = _tree()
    jb = jopt.build_tx(jcfg, tree)
    tparams = params_to_torch(tree)
    tb = topt.build_tx(tcfg, tparams)
    assert isinstance(tb.tx, topt.Adam) and tb.tx.decoupled == (method == "adamw") and tb.tx.lars == lars
    jstate, tstate = jb.tx.init(tree), tb.tx.init(tparams)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), tree)
        jd, jstate = jax.jit(jb.tx.update)(grads, jstate, tree)
        td, tstate = tb.tx.update(params_to_torch(grads), tstate, tparams)
        for k, v in params_to_torch(jax.device_get(jd)).items():
            assert float((td[k] - v).abs().max()) <= 1e-6 * float(v.abs().max()) + 1e-30, k
    assert tstate["count"] == 3


def _rev_mvit_s_cfg(mod, **overrides):
    """configs/pretrain/MViT_S_rev_masked.yaml with MVIT.REV.ENABLE at a
    reduced MViT-S (width 8, 6 blocks, the doubling and Q pooling at blocks
    1 and 3), 4 frames at 32^2, float32, SOLVER.LAYER_DECAY 0.75."""
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/MViT_S_rev_masked.yaml")
    _override(cfg, {"NUM_GPUS": 1, "NUM_WORLDS": 1, "TPU.MESH_SYNC": 1, "TPU.COMPUTE_DTYPE": "float32",
                    "MVIT.EMBED_DIM": 8, "MVIT.DEPTH": 6, "MVIT.REV.ENABLE": True,
                    "MVIT.DIM_MUL": [[1, 2.0], [3, 2.0]], "MVIT.HEAD_MUL": [[1, 2.0], [3, 2.0]],
                    "MVIT.POOL_Q_STRIDE": [[1, 1, 2, 2], [3, 1, 2, 2]], "MVIT.DROPPATH_RATE": 0.0,
                    "MASK.PRETRAIN_DEPTH": [5], "DATA.NUM_FRAMES": 4, "DATA.TRAIN_CROP_SIZE": 32,
                    "DATA.TEST_CROP_SIZE": 32, "AUG.TARGET_SIZE": 32, "DATA.BATCHSIZE_PER_GPU": 2,
                    "SOLVER.LAYER_DECAY": 0.75, **overrides})
    return mod.assert_and_infer_cfg(cfg)


def _jax_scales_by_torch_name(jcfg, t, s):
    """JAX's layer_decay_scales over the model's parameter shapes
    (``jax.eval_shape``, nothing computed), keyed by the port's names: a
    stacked reversible leaf gives one entry per block."""
    model = jbuild_model(jcfg, sync_axes=())
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)},
        jnp.zeros((1, t, s, s, 3), jnp.float32), train=False))["params"]
    scales = jopt.layer_decay_scales(jcfg, shapes)
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    for (path, leaf), sc in zip(leaves, jax.tree_util.tree_leaves(scales)):
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        at = next((i for i, p in enumerate(keys) if re.fullmatch(r"rev_seg\d+_[fg]", p)), None)
        if at is None:
            out[param_key(keys)] = sc
        else:
            for b in range(leaf.shape[0]):
                out[param_key(keys[:at + 1] + (str(b),) + keys[at + 1:])] = sc
    return out


@pytest.mark.parametrize("tree", ["rev_mvit_s", "mae"])
def test_layer_decay_scales_match_jax(tree):
    """SOLVER.LAYER_DECAY 0.75: every parameter's lr scale equals JAX's for
    the same parameter, read off its Flax path (the reversible segments
    stacked, so no block index; the MAE decoder's blocks inside the
    prediction head); scales spread over several depths; frozen parameters
    (LINEAR_PROBING) get 0."""
    if tree == "mae":
        jcfg, tcfg = (mae_cfg(m, **{"SOLVER.LAYER_DECAY": 0.75}) for m in (jconfig, tconfig))
        t, s = MAE_T, MAE_S
    else:
        jcfg, tcfg = _rev_mvit_s_cfg(jconfig), _rev_mvit_s_cfg(tconfig)
        t, s = 4, 32
    want = _jax_scales_by_torch_name(jcfg, t, s)
    with torch.device("meta"):
        model = MODEL_REGISTRY[tcfg.MODEL.MODEL_NAME](tcfg, get_norm(tcfg), compute_dtype(tcfg))
    params = dict(model.named_parameters())
    got = topt.lr_scales(tcfg, params)
    assert set(got) == set(want)
    assert got == want
    assert len(set(got.values())) >= 3
    if tree == "rev_mvit_s":
        assert any(".rev_seg" in n or n.startswith("rev_seg") for n in got)
    bundle = topt.build_tx(tcfg, params)
    assert bundle.lr_scales == got
    probe = tcfg.clone()
    probe.LINEAR_PROBING = True
    frozen = topt.lr_scales(probe, params)
    assert all(v == 0.0 for n, v in frozen.items() if "head" not in n)


def test_flax_path_inverts_param_key():
    """``flax_path`` of a torch name: the reversible block index dropped, a
    kernel or a norm scale named as in Flax."""
    w2, w1 = torch.zeros(2, 2), torch.zeros(2)
    assert topt.flax_path("backbone.rev_seg1_f.3.attn.qkv.weight", w2) == "backbone/rev_seg1_f/attn/qkv/kernel"
    assert topt.flax_path("blocks_4.norm1.weight", w1) == "blocks_4/norm1/scale"
    assert topt.flax_path("pred_head.transform_0.blocks_1.mlp.fc1.bias", w1) == \
        "pred_head/transform_0/blocks_1/mlp/fc1/bias"
