"""The port's X3D (advise_tpu_torch/models/x3d.py) and its layers (SE,
X3DTransform, drop-connect, X3DStem, X3DHead, Nonlocal) against the JAX
package's, with the JAX initial variables passed through the param bridge,
and the X3D speed step against JAX's over 3 steps.

Tolerances (float32). Module outputs in train mode (batch statistics over
a few samples) and eval mode: 1e-4 of the largest output (measured below
2e-6); the parameter gradients of a weighted sum of the outputs: 2e-3 of
each tensor's largest entry, as tests/test_torch_resnet3d.py (XLA-CPU's
sequential float32 reductions), plus 2e-5 of the largest gradient of the
module for the tensors whose exact gradient is zero (the Nonlocal's phi and
g biases, shifted away by the softmax and the out BN); the BN running
statistics: 1e-5. The
reduced X3D (DEPTH_FACTOR 0.5, 4 frames at 32^2): logits 1e-3 of the
largest in train mode (its 4-clip BN at s5 amplifies the order of sums),
1e-5 in eval mode. The 3-step speed trajectory compares what each tensor
MOVED, as tests/test_torch_speed_step.py: within 1e-2 of the JAX move plus
1e-6 of the tree's largest value; the loss and accuracy to 1e-4, the grad
norm to 1e-3 relative.
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
from advise_tpu.models.layers import heads as jheads
from advise_tpu.models.layers import nonlocal_block as jnl
from advise_tpu.models.layers import resnet as jresnet
from advise_tpu.models.layers import stem as jstem
from advise_tpu.models.layers.norm import get_norm as jget_norm
from advise_tpu.models.layers.operators import SE as JSE
from advise_tpu.parallel import build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_train_step
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers import heads as theads
from advise_tpu_torch.models.layers import nonlocal_block as tnl
from advise_tpu_torch.models.layers import resnet as tresnet
from advise_tpu_torch.models.layers import stem as tstem
from advise_tpu_torch.models.layers.common import draw_keep
from advise_tpu_torch.models.layers.norm import commit_bn_stats, get_norm
from advise_tpu_torch.models.layers.operators import SE
from advise_tpu_torch.models.x3d import X3D
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import batch_stats_to_torch, flax_to_state_dict, params_to_torch

from torch_port_common import on_mesh, rel_err

torch.set_num_threads(1)

B, T, S = 4, 4, 32  # clips, frames, pixels of the reduced model
VB, VK = 2, 2  # videos and clips of the speed step
LR = float(np.float32(1e-3))


def x3d_cfg(mod, **overrides):
    """X3D_M_K400.yaml on one device in float32 with REMAT, cut to
    DEPTH_FACTOR 0.5 (stages of 1, 1, 3, 2 blocks), DIM_C5 64, no head
    dropout, 4 frames at 32^2."""
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/pretrain/X3D_M_K400.yaml")
    cfg.NUM_WORLDS = 1
    cfg.NUM_GPUS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DONATE = False
    cfg.X3D.DEPTH_FACTOR = 0.5
    cfg.X3D.DIM_C5 = 64
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.DATA.NUM_FRAMES = T
    cfg.DATA.BATCHSIZE_PER_GPU = VB
    cfg.DATA.NUM_CLIP = VK
    cfg.AUG.TARGET_SIZE = S
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return mod.assert_and_infer_cfg(cfg)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ncdhw(x):
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _norms():
    return jget_norm(jconfig.get_cfg(), ()), get_norm(tconfig.get_cfg())


def _pair(jmod, tmod, x, call_j, call_t, train=True, set_params=None, rel_out=1e-4,
          init=lambda m, xx: m.init(jax.random.PRNGKey(0), xx, False)):
    """Initialise ``jmod`` on ``x`` (NDHWC) by ``init``, load its variables
    into ``tmod`` and compare the outputs, the gradients of sum(out * w) and
    (train mode) the updated running statistics. ``call_j(mod, variables,
    x, train)`` and ``call_t(mod, x)`` apply each side; ``set_params`` edits
    the Flax params first. Returns the port's output."""
    variables = jax.jit(lambda: init(jmod, jnp.asarray(x)))()
    params = jax.device_get(variables["params"])
    batch_stats = jax.device_get(variables.get("batch_stats", {}))
    if set_params is not None:
        params = set_params(params)
    tmod.load_state_dict(flax_to_state_dict(params, batch_stats))
    tmod.train(train)
    out_t = call_t(tmod, x)
    w = _x(tuple(out_t.shape), 9)

    def loss(p):
        out = call_j(jmod, {"params": p, "batch_stats": batch_stats}, jnp.asarray(x), train)
        out, mut = out if train else (out, {})
        return jnp.sum(out * w), (out, mut)

    (_, (out_j, mut)), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tmod.zero_grad()
    (out_t * torch.from_numpy(w)).sum().backward()
    commit_bn_stats(tmod)
    assert rel_err(out_t.detach().numpy(), out_j) <= rel_out
    grads = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
    wants = {k: v.numpy() for k, v in params_to_torch(jax.device_get(g_j)).items()}
    assert set(grads) == set(wants)
    top = max(float(np.abs(v).max()) for v in wants.values())
    for k, want in wants.items():  # + 2e-5 of the tree: exact zeros (a bias under BN or softmax)
        assert np.abs(grads[k] - want).max() <= 2e-3 * np.abs(want).max() + 2e-5 * top, k
    if train and mut:
        own = tmod.state_dict()
        for k, want in batch_stats_to_torch(jax.device_get(mut["batch_stats"])).items():
            np.testing.assert_allclose(own[k].numpy(), want.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)
    return out_t


def _apply_nd(mod, v, x, train):
    if train:
        return mod.apply(v, x, train, mutable=["batch_stats"])
    return mod.apply(v, x, train)


def _port_nd(tmod, x):
    return tmod(_ncdhw(x)).permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("dim", [24, 54, 200])
def test_se_matches_jax(dim):
    """SE's widths (_round_width at ratio 0.0625: 8, 8, 16) and its value."""
    x = _x((2, 3, 5, 6, dim), 1)
    jmod = JSE(ratio=0.0625)
    tmod = SE(dim, 0.0625)
    _pair(jmod, tmod, x, lambda m, v, xx, train: (m.apply(v, xx), {}) if train else m.apply(v, xx),
          lambda m, xx: m(_ncdhw(xx)).permute(0, 2, 3, 4, 1),
          init=lambda m, xx: m.init(jax.random.PRNGKey(0), xx))
    assert tmod.fc1.out_channels == max(8, int(dim * 0.0625 + 4) // 8 * 8)


def test_se_keeps_float32_under_bf16():
    """As the JAX SE (float32 parameters promote): bf16 in, float32 out."""
    x = torch.randn(2, 16, 2, 3, 3).bfloat16()
    assert SE(16, 0.0625)(x).dtype == torch.float32
    jmod = JSE(ratio=0.0625)
    xj = jnp.ones((2, 2, 3, 3, 16), jnp.bfloat16)
    assert jmod.apply(jmod.init(jax.random.PRNGKey(0), xj), xj).dtype == jnp.float32


@pytest.mark.parametrize("block_idx", [0, 1])  # SE on even blocks only
@pytest.mark.parametrize("train", [True, False])
def test_x3d_transform_matches_jax(block_idx, train):
    jn, tn = _norms()
    x = _x((B, 4, 8, 8, 16), 2)
    jmod = jresnet.X3DTransform(dim_out=24, dim_inner=54, temp_kernel_size=3, stride=2, norm=jn,
                                block_idx=block_idx)
    tmod = tresnet.X3DTransform(16, 24, 54, 3, 2, tn, block_idx=block_idx)
    assert (tmod.se is None) == (block_idx % 2 == 1)
    _pair(jmod, tmod, x, _apply_nd, _port_nd, train=train)


def test_x3d_stem_matches_jax():
    jn, tn = _norms()
    x = _x((B, 6, 16, 16, 3), 3)
    _pair(jstem.X3DStem(dim_out=24, temp_kernel=5, norm=jn), tstem.X3DStem(3, 24, 5, tn), x,
          _apply_nd, _port_nd)


@pytest.mark.parametrize("mlp", [False, True])
def test_x3d_head_matches_jax(mlp):
    """The single-fc head (eval: softmax) and the MLP projection with BN
    plus a BYOL predictor (train: [proj, pred])."""
    jn, tn = _norms()
    x = _x((B, 2, 3, 3, 48), 4)
    kw = dict(num_mlp_layers=2, mlp_dim=32, bn_mlp=True, predictor_depths=(2,), predictor_mlp_dim=32,
              predictor_bn=True) if mlp else {}
    jmod = jheads.X3DHead(dim_inner=108, dim_out=64, num_classes=16, norm=jn, act_func="softmax", **kw)
    tmod = theads.X3DHead(48, 108, 64, 16, tn, act_func="softmax", **kw)

    def call_j(m, v, xx, train):
        out = m.apply(v, [xx], train, mutable=["batch_stats"]) if train else m.apply(v, [xx], train)
        if mlp:
            out, mut = out
            return jnp.stack(out), mut
        return out

    def call_t(m, xx):
        out = m([_ncdhw(xx)])
        return torch.stack(out) if mlp else out

    out = _pair(jmod, tmod, x, call_j, call_t, train=mlp,
                init=lambda m, xx: m.init(jax.random.PRNGKey(0), [xx], False))
    if not mlp:
        torch.testing.assert_close(out.sum(-1), torch.ones(B))


@pytest.mark.parametrize("instantiation,pool,group", [
    ("softmax", None, 1), ("softmax", (1, 2, 2), 2), ("dot_product", (1, 2, 2), 1),
    ("dot_product", None, 2)])
def test_nonlocal_matches_jax(instantiation, pool, group):
    """Both instantiations, the VALID key/value pool on and off, the
    temporal fold of 1 and 2 groups; the zero-initialized out BN scale set
    to 1, so that the attention reaches the output."""
    jn, tn = _norms()
    x = _x((2, 4, 6, 6, 16), 5)

    def ones_scale(p):
        p = jax.tree_util.tree_map(np.asarray, p)
        p["out_bn"]["scale"] = np.ones_like(p["out_bn"]["scale"])
        return p

    jmod = jnl.Nonlocal(dim_inner=8, norm=jn, pool_size=pool, instantiation=instantiation, group_size=group)
    tmod = tnl.Nonlocal(16, 8, tn, pool_size=pool, instantiation=instantiation, group_size=group)
    _pair(jmod, tmod, x, _apply_nd, _port_nd, set_params=ones_scale)
    tmod.eval()
    tmod.out_bn.weight.data.zero_()
    with torch.no_grad():  # zero-initialized: the identity
        assert torch.equal(tmod(_ncdhw(x)), _ncdhw(x))


def test_nonlocal_in_resstage_matches_jax():
    """NONLOCAL.LOCATION inserts ``pathway0_nonlocal{i}`` after block i."""
    jn, tn = _norms()
    kw = dict(dim_in=[8], dim_out=[16], dim_inner=[4], temp_kernel_sizes=[[3]], stride=[1],
              num_blocks=[2], num_groups=[1], num_block_temp_kernel=[2], norm=jn,
              nonlocal_inds=[(0,)], nonlocal_group=[2], nonlocal_pool=[[1, 2, 2]],
              instantiation="softmax")
    jmod = jresnet.ResStage(**kw)
    tmod = tresnet.ResStage(**{**kw, "norm": tn})
    assert hasattr(tmod, "pathway0_nonlocal0") and not hasattr(tmod, "pathway0_nonlocal1")
    x = _x((2, 4, 8, 8, 8), 6)

    def ones_scale(p):
        p = jax.tree_util.tree_map(np.asarray, p)
        p["pathway0_nonlocal0"]["out_bn"]["scale"] = np.ones_like(p["pathway0_nonlocal0"]["out_bn"]["scale"])
        return p

    _pair(jmod, tmod, x, lambda m, v, xx, train: (
        lambda o: (o[0][0], o[1]))(m.apply(v, [xx], train, mutable=["batch_stats"])),
        lambda m, xx: m([_ncdhw(xx)])[0].permute(0, 2, 3, 4, 1), set_params=ones_scale,
        init=lambda m, xx: m.init(jax.random.PRNGKey(0), [xx], False))


def test_drop_connect_with_a_given_mask():
    """The branch divided by the keep probability where the mask is set, 0
    elsewhere: the block's output is relu(shortcut + that)."""
    tn = get_norm(tconfig.get_cfg())
    block = tresnet.ResBlock(8, 8, 16, 3, 1, tn, trans_func_name="x3d_transform", drop_connect_rate=0.25,
                             se_ratio=0.0625)
    block.train()
    x = torch.randn(4, 8, 2, 5, 5)
    keep = torch.tensor([True, False, True, False])
    with torch.no_grad():
        branch = block.branch2(x)
        got = block(x, keep=keep)
    want = torch.relu(x + torch.where(keep.view(-1, 1, 1, 1, 1), branch / 0.75, torch.zeros(())))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.no_grad():
        assert torch.equal(block(x), torch.relu(x + block.branch2(x)))  # no mask: the identity on the branch


def test_drop_connect_from_a_generator():
    """X3D's per-stage rate DROPCONNECT_RATE * (s + 2) / 5, masks drawn by
    each stage from the caller's generator: over 2^14 samples the kept
    share is within 0.015 of 1 - rate (4 sd of the sampling noise are
    0.014); none in eval mode; the same generator state draws the same
    masks."""
    cfg = x3d_cfg(tconfig, **{"MODEL.DROPCONNECT_RATE": 0.5})
    model = X3D(cfg, get_norm(cfg))
    rates = [getattr(model, f"s{s + 2}").drop_connect_rate for s in range(4)]
    assert rates == pytest.approx([0.5 * (s + 2) / 5 for s in range(4)])
    stage = model.s5
    stage.train()
    x = [torch.zeros(2 ** 14, 1)]
    keeps = stage.draw_keeps(x, torch.Generator().manual_seed(0))
    share = float(keeps[0][0].float().mean())
    assert abs(share - (1 - stage.drop_connect_rate)) < 0.015
    again = stage.draw_keeps(x, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(keeps[0], again[0]))
    with pytest.raises(ValueError):
        stage.draw_keeps(x, None)
    stage.eval()
    assert stage.draw_keeps(x, None) == [[None] * stage.num_blocks[0]]
    draw = draw_keep(8, 0.0, None)
    assert draw is None


def test_x3d_m_param_count_equals_jax():
    """X3D-M at 400 classes: tests/test_x3d.py's oracle, built on the meta
    device; and the preset's own 4-class head."""
    cfg = tconfig.get_cfg()
    cfg.merge_from_file("configs/pretrain/X3D_M_K400.yaml")
    cfg.NUM_WORLDS, cfg.TPU.MESH_SYNC, cfg.BN.NUM_SYNC_DEVICES = 1, 1, 1
    cfg.MODEL.NUM_CLASSES = 400
    cfg = tconfig.assert_and_infer_cfg(cfg)
    with torch.device("meta"):
        model = X3D(cfg, get_norm(cfg))
    assert sum(p.numel() for p in model.parameters()) == 3_794_322
    assert [len([n for n, _ in getattr(model, f"s{s + 2}").named_children() if "_res" in n])
            for s in range(4)] == [3, 5, 11, 7]


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = x3d_cfg(jconfig), x3d_cfg(tconfig)
    jm = jbuild_model(jcfg, sync_axes=())
    v = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                jnp.zeros((1, T, S, S, 3), jnp.float32), train=False))()
    return jcfg, tcfg, jm, jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def test_reduced_x3d_bridge_forward_and_grads(reduced):
    """Every Flax leaf lands on a port tensor of the same shape; the logits
    in eval and train mode, the gradients and the running statistics."""
    _, tcfg, jm, params, batch_stats = reduced
    tm = build_model(tcfg, "cpu")
    sd = flax_to_state_dict(params, batch_stats)
    assert set(sd) == set(tm.state_dict())
    x = _x((B, T, S, S, 3), 7)
    out_e = jm.apply({"params": params, "batch_stats": batch_stats}, x, train=False)
    tm.load_state_dict(sd)
    tm.eval()
    with torch.no_grad():
        assert rel_err(tm(torch.from_numpy(x)).numpy(), out_e) <= 1e-5
    _pair(jm, tm, x, lambda m, v, xx, train: m.apply(v, xx, train=True, mutable=["batch_stats"]),
          lambda m, xx: m(torch.from_numpy(xx)), rel_out=1e-3)


def test_contrastive_model_over_x3d(reduced):
    """ContrastiveModel ARCH x3d: the X3D head serves the CONTRASTIVE.DIM
    projection MLP and the BYOL predictor; the same outputs as JAX's."""
    over = {"MODEL.MODEL_NAME": "ContrastiveModel", "MODEL.ARCH": "x3d", "TASK": "contrastive",
            "CONTRASTIVE.TYPE": "byol", "CONTRASTIVE.DIM": 16, "CONTRASTIVE.MLP_DIM": 32,
            "CONTRASTIVE.NUM_MLP_LAYERS": 2, "CONTRASTIVE.BN_MLP": True,
            "CONTRASTIVE.PREDICTOR_DEPTHS": [2]}
    jcfg, tcfg = x3d_cfg(jconfig, **over), x3d_cfg(tconfig, **over)
    jm = jbuild_model(jcfg, sync_axes=())
    x = _x((B, T, S, S, 3), 8)
    tm = build_model(tcfg, "cpu")
    assert isinstance(tm.backbone, X3D)
    out = _pair(jm, tm, x, lambda m, v, xx, train: (
        lambda o: (jnp.stack(o[0]), o[1]))(m.apply(v, xx, train=True, mutable=["batch_stats"])),
        lambda m, xx: torch.stack(m(torch.from_numpy(xx))), rel_out=1e-3)
    assert tuple(out.shape) == (2, B, 16)


def test_three_step_speed_trajectory_matches_jax(reduced):
    """X3D_M_K400.yaml's speed step (simple_sgd, BCE, REMAT), reduced, from
    the same state, the augmentation held apart: 3 steps."""
    jcfg, tcfg, _, params, batch_stats = reduced
    mesh = build_mesh(jcfg, jax.devices()[:1])
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32)), mesh)
    model = build_model(tcfg, "cpu")
    model.load_state_dict(flax_to_state_dict(params, batch_stats))
    named = dict(model.named_parameters())
    tbundle = build_tx(tcfg, named)
    tstate = TrainState(model, tbundle.tx.init(named), 0)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    tstep = make_train_step(tcfg, tbundle, None)
    for i in range(3):
        clips = _x((VB, VK, T, S, S, 3), 20 + i)
        labels = np.random.default_rng(30 + i).integers(0, 4, (VB, VK)).astype(np.int32)
        jstate, jstats = jstep(jstate, jnp.asarray(clips), {"spd_label": labels}, jax.random.PRNGKey(i),
                               jnp.float32(LR))
        tstats = tstep(tstate, torch.from_numpy(clips), {"spd_label": torch.from_numpy(labels)}, None, LR)
        for k in ("loss_spd", "acc_spd"):
            assert abs(tstats[k].item() - float(jstats[k])) <= 1e-4, (i, k)
        assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
    jstate = jax.device_get(jstate)
    own = model.state_dict()
    p0 = params_to_torch(params)
    for want, init in ((params_to_torch(jstate.params), p0),
                       (batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(batch_stats))):
        top = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            g, w, i0 = (np.asarray(a, np.float32) for a in (own[k], v, init[k]))
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w - i0).max() + 1e-6 * top, k
