"""The port's MViT (advise_tpu_torch/models/mvit.py, layers/attention.py,
parallel/reversible.py) against the JAX package's: the block schedule, the
attention module and block with converted params, and the reversible MViT,
forward and every parameter gradient. JAX runs its flash attention (K4) in
TPU interpret mode; the port's runs the kernels' plain versions on the CPU.

Tolerances (float32): a module's output and gradients agree to float32
rounding of sums taken in another order, 1e-5 of the largest value for a
module and 1e-4 for the whole model (JAX's side is jitted: compiled once,
it runs in seconds where op-by-op dispatch took minutes) (12 attention and MLP sub-blocks deep);
each gradient also gets 1e-2 of that tolerance times the largest gradient of
the model, for gradients that are zero in exact arithmetic
(``torch_port_common.grads_agree``).
The reversible backward reconstructs each block's input by subtraction,
which costs float32 rounding of the streams: the port-only check of the
autograd.Function against plain autograd holds it to 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advise_tpu import config as jconfig
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models.layers.attention import MultiScaleAttention as JMSA
from advise_tpu.models.layers.attention import MultiScaleBlock as JBlock
from advise_tpu.models.layers.heads import MLPHead as JMLPHead
from advise_tpu.models.mvit import mvit_block_schedule as jschedule
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.attention import MultiScaleAttention, MultiScaleBlock
from advise_tpu_torch.models.layers.heads import MLPHead
from advise_tpu_torch.models.layers.common import draw_keep
from advise_tpu_torch.models.mvit import _call_sub, mvit_block_schedule
from advise_tpu_torch.parallel.reversible import reversible_block_scan
from advise_tpu_torch.utils.convert import params_to_torch
from tests.test_transformers import _mvit_cfg

from torch_port_common import MASK_S, MASK_T, grads_agree, masked_cfg, rel_err

torch.set_num_threads(1)


def _port_cfg(jcfg):
    tcfg = tconfig.get_cfg()
    tcfg.merge_from_other_cfg(jcfg.to_dict())
    return tcfg


def _preset(mod, path):
    cfg = mod.get_cfg()
    cfg.merge_from_file(path)
    return mod.assert_and_infer_cfg(cfg)


@pytest.mark.parametrize("source", ["configs/pretrain/MViT_L_32x312_joint.yaml",
                                    "configs/pretrain/MViT_S_rev_masked.yaml", "tiny"])
def test_block_schedule_matches_jax(source):
    if source == "tiny":
        jcfg = _mvit_cfg()
        tcfg = _port_cfg(jcfg)
    else:
        jcfg, tcfg = _preset(jconfig, source), _preset(tconfig, source)
    for dims in (None, (16, 78, 78), (2, 7, 7)):
        want, want_dim = jschedule(jcfg, dims)
        got, got_dim = mvit_block_schedule(tcfg, dims)
        assert got_dim == want_dim
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a == b


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("flash,cls,res", [(True, False, True), (False, True, False),
                                           (True, False, False)])
def test_multiscale_attention_matches_jax(flash, cls, res):
    """Q pooled by 2 in space, K/V by 4, conv pools with LayerNorm; with
    ``res`` a residual pooled through the same pool_q/norm_q (RES_PATH
    'conv')."""
    thw = (2, 8, 8)
    n = 2 * 8 * 8 + (1 if cls else 0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n, 12)).astype(np.float32)
    kw = dict(num_heads=2, qkv_bias=True, kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3),
              stride_q=(1, 2, 2), stride_kv=(1, 4, 4), has_cls_embed=cls, flash=flash)
    jmod = JMSA(dim_out=16, input_size=thw, **kw)
    tmod = MultiScaleAttention(12, 16, **kw)
    if res:
        x_res = rng.standard_normal((2, n, 16)).astype(np.float32)
        jkw = {"x_res": jnp.asarray(x_res)}
    else:
        jkw = {}
    params = jax.device_get(jax.jit(lambda: jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), thw,
                                                      **jkw))())["params"]

    def jloss(p, xx):
        out = jmod.apply({"params": p}, xx, thw, **jkw)
        extra = jnp.sum(jnp.cos(out[2])) if res else 0.0
        return jnp.sum(out[0] * jnp.sin(out[0])) + extra, out

    ctx = pltpu.force_tpu_interpret_mode() if flash else _null()
    with ctx:
        (_, out_j), (gp, gx) = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(
            params, jnp.asarray(x))
    tmod.load_state_dict(params_to_torch(params))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmod(xt, thw, torch.from_numpy(x_res)) if res else tmod(xt, thw)
    loss = torch.sum(out_t[0] * torch.sin(out_t[0]))
    if res:
        loss = loss + torch.sum(torch.cos(out_t[2]))
        assert rel_err(out_t[2].detach().numpy(), out_j[2]) <= 1e-5
    loss.backward()
    assert tuple(out_t[1]) == tuple(out_j[1]) == (2, 4, 4)
    assert rel_err(out_t[0].detach().numpy(), out_j[0]) <= 1e-5
    assert rel_err(xt.grad.numpy(), gx) <= 1e-5
    grads = {name: p.grad.numpy() for name, p in tmod.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(gp)), 1e-5)


@pytest.mark.parametrize("flash,cls", [(True, False), (False, True)])
def test_multiscale_block_matches_jax(flash, cls):
    """A Q-pooling block that doubles the width (projected, max-pooled skip)."""
    thw = (2, 8, 8)
    n = 2 * 8 * 8 + (1 if cls else 0)
    x = np.random.default_rng(1).standard_normal((2, n, 8)).astype(np.float32)
    kw = dict(num_heads=2, mlp_ratio=4.0, qkv_bias=True, kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3),
              stride_q=(1, 2, 2), stride_kv=(1, 2, 2), has_cls_embed=cls, flash=flash)
    jmod = JBlock(dim=8, dim_out=16, input_size=thw, **kw)
    tmod = MultiScaleBlock(8, 16, **kw)
    params = jax.device_get(jax.jit(lambda: jmod.init(jax.random.PRNGKey(4), jnp.asarray(x), thw))())["params"]

    def jloss(p, xx):
        out = jmod.apply({"params": p}, xx, thw)
        return jnp.sum(out[0] * jnp.sin(out[0])), out

    ctx = pltpu.force_tpu_interpret_mode() if flash else _null()
    with ctx:
        (_, out_j), (gp, gx) = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(
            params, jnp.asarray(x))
    tmod.load_state_dict(params_to_torch(params))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmod(xt, thw)
    torch.sum(out_t[0] * torch.sin(out_t[0])).backward()
    assert tuple(out_t[1]) == tuple(out_j[1])
    assert rel_err(out_t[0].detach().numpy(), out_j[0]) <= 1e-5
    assert rel_err(xt.grad.numpy(), gx) <= 1e-5
    grads = {name: p.grad.numpy() for name, p in tmod.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(gp)), 1e-5)


def test_mlp_head_without_bn_matches_jax():
    """The joint projector: 3 layers, biases, no BN."""
    x = np.random.default_rng(2).standard_normal((4, 12)).astype(np.float32)
    jh = JMLPHead(dim_out=6, mlp_dim=10, num_layers=3)
    params = jax.device_get(jh.init(jax.random.PRNGKey(5), jnp.asarray(x), True))["params"]
    th = MLPHead(12, 6, 10, 3)
    th.load_state_dict(params_to_torch(params))
    with torch.no_grad():
        got = th(torch.from_numpy(x)).numpy()
    assert rel_err(got, jh.apply({"params": params}, jnp.asarray(x), True)) <= 1e-5


def test_plain_mvit_matches_jax():
    """The plain (non-reversible) walk on the tiny config of
    tests/test_transformers.py: cls token, one position table, two
    Q-pooling blocks that double the width, the cls head; logits and every
    parameter gradient of sum(tanh(logits)) in training (drop path 0)."""
    jcfg = _mvit_cfg(**{"MVIT.DROPPATH_RATE": 0.0})
    jcfg = jconfig.assert_and_infer_cfg(jcfg)
    tcfg = _port_cfg(jcfg)
    jm = jbuild_model(jcfg, sync_axes=())
    x = np.random.default_rng(6).standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                    train=False))()["params"])

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(jnp.tanh(out)), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = build_model(tcfg, "cpu")
    assert hasattr(tm, "cls_token") and hasattr(tm, "pos_embed") and hasattr(tm, "blocks_3")
    tm.load_state_dict(params_to_torch(params))
    tm.train()
    out_t = tm(torch.from_numpy(x))
    torch.sum(torch.tanh(out_t)).backward()
    assert rel_err(out_t.detach().numpy(), out_j) <= 1e-4
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(g_j)), 1e-4)


def _rev_cfgs(**kw):
    over = {"MODEL.MODEL_NAME": "MViT", "MODEL.NUM_CLASSES": 5, "MODEL.HEAD_ACT": "none", **kw}
    return masked_cfg(jconfig, **over), masked_cfg(tconfig, **over)


def jax_rev_value_and_grad(jcfg, loss_fn, params):
    """JAX's forward with its flash kernel interpreted, and the value and
    gradients with the dense chain: the reversible walk always runs its
    transitions under ``nn.remat``, and JAX cannot differentiate the
    interpreted Pallas kernel (whose callbacks are effects) inside remat.
    tests/test_flash_attention.py holds JAX's flash to the dense chain at
    1e-5 on a whole MViT, forward and gradients."""
    jm = jbuild_model(jcfg, sync_axes=())
    with pltpu.force_tpu_interpret_mode():
        out_flash = jax.jit(lambda p: loss_fn(jm, p)[1])(params)
    dense = jcfg.clone()
    dense.TPU.FLASH_ATTENTION = False
    (val, out), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(jbuild_model(dense, sync_axes=()), p), has_aux=True))(params)
    return out_flash, val, out, grads


def test_reversible_mvit_matches_jax():
    """The reversible MViT classifier (REV with O1_SCAN, flash on in the port,
    drop path 0): a uniform segment of 1 block, two transitions, a segment of
    3; the logits (against JAX's interpreted flash and its dense chain) and
    every parameter gradient of sum(tanh(logits))."""
    jcfg, tcfg = _rev_cfgs()
    jm = jbuild_model(jcfg, sync_axes=())
    x = np.random.default_rng(3).standard_normal((2, MASK_T, MASK_S, MASK_S, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=False))()["params"])

    def jloss(model, p):
        out = model.apply({"params": p}, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.sum(jnp.tanh(out)), out

    out_flash, _, out_j, g_j = jax_rev_value_and_grad(jcfg, jloss, params)
    tm = build_model(tcfg, "cpu")
    assert [n for n in ("rev_seg0_f", "blocks_1", "blocks_2", "rev_seg1_f") if hasattr(tm, n)] == [
        "rev_seg0_f", "blocks_1", "blocks_2", "rev_seg1_f"]
    assert len(tm.rev_seg1_f) == 3
    tm.load_state_dict(params_to_torch(params))
    tm.train()
    out_t = tm(torch.from_numpy(x))
    torch.sum(torch.tanh(out_t)).backward()
    assert rel_err(out_t.detach().numpy(), out_flash) <= 1e-4
    assert rel_err(out_t.detach().numpy(), out_j) <= 1e-4
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert not grads_agree(grads, params_to_torch(jax.device_get(g_j)), 1e-4)


def test_reversible_function_matches_plain_autograd_with_drop_path():
    """Port only: on the tiny model's 3-block segment with drop path 0.5, the
    reversible autograd.Function gives the outputs and the input and
    parameter gradients of plain autograd through the same coupling and the
    same keep masks (which do drop samples), replayed in the backward.
    (Streams that a transition's drop path zeroed exactly are avoided: there
    the reconstruction's float32 residue, ~1e-8, is what LayerNorm
    normalises, in the reference's algorithm as in the port's.)"""
    _, tcfg = _rev_cfgs(**{"MVIT.DROPPATH_RATE": 0.5})
    tm = build_model(tcfg, "cpu", seed=1).train()
    fs, gs = tm.rev_seg1_f, tm.rev_seg1_g
    gen = torch.Generator().manual_seed(9)
    keeps = [[draw_keep(4, fs[k].drop_path.rate, gen) for k in range(3)] for _ in range(2)]
    assert all(fs[k].drop_path.rate > 0 for k in range(3))
    assert sum(int((~m).sum()) for ks in keeps for m in ks) > 0
    rng = np.random.default_rng(5)
    shape = (4, 2 * 4 * 4, fs[0].norm1.normalized_shape[0])
    x_in = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2)]
    f = functools.partial(_call_sub, fs, keeps[0])
    g = functools.partial(_call_sub, gs, keeps[1])
    params = [list(fs[k].parameters()) + list(gs[k].parameters()) for k in range(3)]
    results = []
    for o1 in (True, False):
        tm.zero_grad()
        x1, x2 = (a.clone().requires_grad_() for a in x_in)
        if o1:
            y1, y2 = reversible_block_scan(f, g, params, x1, x2)
        else:
            y1, y2 = x1, x2
            for k in range(3):
                y1 = y1 + f(k, y2)
                y2 = y2 + g(k, y1)
        torch.sum(torch.tanh(y1) * y2).backward()
        grads = {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}
        grads.update(x1=x1.grad, x2=x2.grad)
        results.append((y1.detach(), y2.detach(), grads))
    (a1, a2, ga), (b1, b2, gb) = results
    assert rel_err(a1.numpy(), b1.numpy()) <= 1e-6 and rel_err(a2.numpy(), b2.numpy()) <= 1e-6
    assert len(gb) == 2 + sum(len(ps) for ps in params)
    assert not grads_agree(ga, gb, 1e-5)
