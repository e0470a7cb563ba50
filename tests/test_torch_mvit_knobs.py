"""MViT's remaining knobs in the port (``models/mvit.py``,
``models/layers/attention.py``) against the JAX package, with the JAX
model's parameters converted through ``utils/convert.py``: MVIT.POOL_FIRST,
MODE max / avg / conv_unshared, SEPARATE_QKV, LAYER_SCALE_INIT_VALUE,
DROPOUT_RATE, NORM_STEM, PATCH_2D, HEAD_INIT_SCALE and REV.RES_PATH 'max',
each a case of one test on a 3-block MViT 16 wide (2 heads, doubling to 32
and 4 at block 1, which pools Q), in the plain walk (cls token) and the
reversible one; one backward over a combined set; dropout in training.

Tolerances (float32, as tests/test_torch_mvit.py): the logits within 1e-4
of the largest, every gradient within 1e-4 (``grads_agree``). The port runs
its flash route (K4's plain version on the CPU), JAX its dense chain.
Dropout cannot draw JAX's bits: it is held in evaluation (the identity, so
the logits equal JAX's) and in training to the port's own replay: a
recomputed block (REMAT, the reversible backward) draws the masks it drew
the first time, so the recomputing runs give the plain runs' logits and
gradients within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.models import build_model as jbuild_model
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.models import build_model
from advise_tpu_torch.utils.convert import params_to_torch
from torch_port_common import _override, grads_agree, rel_err

torch.set_num_threads(1)

T, S = 4, 32
BASE = {"MODEL.MODEL_NAME": "MViT", "MODEL.NUM_CLASSES": 5, "MODEL.HEAD_ACT": "none",
        "MVIT.EMBED_DIM": 16, "MVIT.NUM_HEADS": 2, "MVIT.DEPTH": 3, "MVIT.DIM_MUL": [[1, 2.0]],
        "MVIT.HEAD_MUL": [[1, 2.0]], "MVIT.POOL_Q_STRIDE": [[1, 1, 2, 2]],
        "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 4, 4], "MVIT.POOL_KVQ_KERNEL": [3, 3, 3],
        "MVIT.PATCH_PADDING": [1, 3, 3], "MVIT.QKV_BIAS": True, "MVIT.DROPPATH_RATE": 0.0,
        "DATA.NUM_FRAMES": T, "DATA.TRAIN_CROP_SIZE": S, "DATA.TEST_CROP_SIZE": S,
        "TPU.COMPUTE_DTYPE": "float32", "NUM_GPUS": 1, "TPU.MESH_SYNC": 1}
REV = {"MVIT.REV.ENABLE": True, "MVIT.CLS_EMBED_ON": False}


def _cfgs(**over):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_cfg()
        _override(cfg, {**BASE, **over})
        out.append(mod.assert_and_infer_cfg(cfg))
    out[0].TPU.FLASH_ATTENTION, out[1].TPU.FLASH_ATTENTION = False, True
    return out


def _jax_params(jcfg, x):
    jm = jbuild_model(jcfg, sync_axes=())
    return jm, jax.device_get(jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False))()["params"])


def _x(seed=6, b=2):
    return np.random.default_rng(seed).standard_normal((b, T, S, S, 3)).astype(np.float32)


CASES = {
    "pool_first": {"MVIT.POOL_FIRST": True},
    "mode_max": {"MVIT.MODE": "max"},
    "mode_avg": {"MVIT.MODE": "avg"},
    "mode_conv_unshared": {"MVIT.MODE": "conv_unshared"},
    "separate_qkv": {"MVIT.SEPARATE_QKV": True},
    "layer_scale": {"MVIT.LAYER_SCALE_INIT_VALUE": 0.1},
    "dropout_eval": {"MVIT.DROPOUT_RATE": 0.2},
    "norm_stem": {"MVIT.NORM_STEM": True},
    "patch_2d": {"MVIT.PATCH_2D": True},
    "head_init_scale": {"MVIT.HEAD_INIT_SCALE": 0.5},
    "rev_res_path_max": {**REV, "MVIT.REV.RES_PATH": "max"},
    "rev_layer_scale": {**REV, "MVIT.LAYER_SCALE_INIT_VALUE": 0.1},
    "rev_pool_first": {**REV, "MVIT.POOL_FIRST": True},
    "rev_mode_max": {**REV, "MVIT.MODE": "max"},
    "rev_separate_qkv": {**REV, "MVIT.SEPARATE_QKV": True},
    "rev_dropout_eval": {**REV, "MVIT.DROPOUT_RATE": 0.2},
    "rev_norm_stem": {**REV, "MVIT.NORM_STEM": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_knob_forward_matches_jax(case):
    """The logits of one knob's model, in evaluation, from JAX's converted
    parameters; the port's built model has JAX's parameter names and
    shapes, and the knobs' initial values (the gammas, the head's scale)."""
    jcfg, tcfg = _cfgs(**CASES[case])
    x = _x()
    jm, params = _jax_params(jcfg, x)
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x), train=False))(params))
    tm = build_model(tcfg, "cpu")
    conv = params_to_torch(params)
    own = dict(tm.named_parameters())
    assert {n: tuple(p.shape) for n, p in own.items()} == {n: tuple(v.shape) for n, v in conv.items()}
    if "layer_scale" in case:
        gammas = [p for n, p in own.items() if "gamma_" in n]
        assert gammas and all(bool((g == 0.1).all()) for g in gammas)
    if case == "head_init_scale":
        jstd, tstd = float(np.std(conv["head.projection.weight"].numpy())), float(own["head.projection.weight"].std())
        assert abs(tstd / jstd - 1) < 0.2 and abs(jstd / 0.005 - 1) < 0.2
    tm.load_state_dict(conv)
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 5)
    assert rel_err(got, want) <= 1e-4


def test_combined_knobs_backward_matches_jax():
    """The reversible walk with RES_PATH 'max', layer scale, MODE avg,
    SEPARATE_QKV and NORM_STEM at once (DEPTH 4: a segment of 2 blocks): the
    logits in training and every parameter gradient of sum(tanh(logits))."""
    over = {**REV, "MVIT.DEPTH": 4, "MVIT.REV.RES_PATH": "max", "MVIT.LAYER_SCALE_INIT_VALUE": 0.5,
            "MVIT.MODE": "avg", "MVIT.SEPARATE_QKV": True, "MVIT.NORM_STEM": True}
    jcfg, tcfg = _cfgs(**over)
    x = _x(3)
    jm, params = _jax_params(jcfg, x)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.sum(jnp.tanh(out)), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = build_model(tcfg, "cpu")
    assert len(tm.rev_seg0_f) == 2
    tm.load_state_dict(params_to_torch(params))
    tm.train()
    out_t = tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    torch.sum(torch.tanh(out_t)).backward()
    assert rel_err(out_t.detach().numpy(), out_j) <= 1e-4
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(g_j)), 1e-4)


@pytest.mark.parametrize("walk", ["plain", "rev"])
def test_dropout_in_training_replays(walk):
    """MVIT.DROPOUT_RATE 0.3 in training: the dropouts change the logits,
    and a run that recomputes its blocks (REMAT; the reversible backward)
    gives the logits and gradients of a run that does not, from the same
    generator seed."""
    over = {"MVIT.DROPOUT_RATE": 0.3, "MVIT.DEPTH": 4, **(REV if walk == "rev" else {})}
    results = []
    for recompute in (True, False):
        extra = {"MVIT.REV.O1_SCAN": recompute} if walk == "rev" else {"TPU.REMAT": recompute}
        _, tcfg = _cfgs(**over, **extra)
        tm = build_model(tcfg, "cpu", seed=1).train()
        x = torch.from_numpy(_x(4))
        out = tm(x, generator=torch.Generator().manual_seed(5))
        torch.sum(torch.tanh(out)).backward()
        results.append((out.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()}))
        if recompute:
            with torch.no_grad():
                assert rel_err(tm.eval()(x).numpy(), out.detach().numpy()) > 1e-3
    (a, ga), (b, gb) = results
    assert rel_err(a.numpy(), b.numpy()) <= 1e-5
    assert not grads_agree(ga, gb, 1e-5)
