"""The port's MoCo (advise_tpu_torch/engine/contrastive.py: the key queue,
shuffle-BN, moco_loss; engine/steps.py: the contrastive step and the kNN
probe with CONTRASTIVE.KNN_BATCH_STATS) against the JAX package's, on
configs/chip/moco_knn_minik400.yaml cut to a Slow R10 (basic transform,
width 8) with the JAX state passed through the param bridge.

Shuffle-BN on one device permutes the local batch: the BN statistics are
the same sums in another order, so the keys agree within float32 rounding
(the port draws its own permutation; JAX's ``compute_keys`` runs inside
shard_map on a one-device mesh, its only form with the shuffle).

Tolerances (float32): the keys and the normalized projections 1e-4 of
their largest entry (measured below 3e-6); the loss 1e-4 relative; the
gradients 1e-2 of the largest gradient, as tests/test_torch_byol.py; BN
running statistics 1e-4. The 3-step trajectory at lr 1e-4 compares what
each tensor MOVED (tests/test_torch_step.py): within 5e-2 of the JAX move
plus 1e-6 of the tree's largest value; the queue rows and the kNN bank
written in the steps to 1e-3 of 1 (they are unit vectors); the pointer
EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from advise_tpu import config as jconfig
from advise_tpu.engine import contrastive as jc
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_knn_probe_step as jmake_probe
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.parallel import BATCH_AXES, build_mesh
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine import contrastive as tc
from advise_tpu_torch.engine.state import TrainState
from advise_tpu_torch.engine.steps import make_knn_probe_step, make_train_step
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.norm import SyncBatchNorm, commit_bn_stats
from advise_tpu_torch.parallel.collectives import batch_shuffle, batch_unshuffle
from advise_tpu_torch.solver.optimizer import build_tx
from advise_tpu_torch.utils.convert import batch_stats_to_torch, convert_train_state, params_to_torch

from torch_port_common import on_mesh, rel_err

torch.set_num_threads(1)

B, K, T, S = 4, 2, 4, 32  # videos, clips (views), frames, pixels
QUEUE, DIM = 16, 16
LR = float(np.float32(1e-4))


def moco_cfg(mod, **overrides):
    cfg = mod.get_cfg()
    cfg.merge_from_file("configs/chip/moco_knn_minik400.yaml")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DONATE = False
    cfg.NUM_WORLDS = 1
    cfg.RESNET.DEPTH = 10
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.CONTRASTIVE.DIM = DIM
    cfg.CONTRASTIVE.MLP_DIM = 32
    cfg.CONTRASTIVE.QUEUE_LEN = QUEUE
    cfg.CONTRASTIVE.LENGTH = 32
    cfg.DATA.NUM_FRAMES = T
    cfg.DATA.BATCHSIZE_PER_GPU = B
    cfg.AUG.TARGET_SIZE = S
    for key, value in overrides.items():
        sec, leaf = key.split(".")
        cfg[sec][leaf] = value
    return mod.assert_and_infer_cfg(cfg)


def _clips(seed):
    return np.random.default_rng(seed).standard_normal((B, K, T, S, S, 3)).astype(np.float32)


# ContrastiveModel over a small Swin (embed 16, depths (2, 2), window (2, 4,
# 4)): the (2, 8, 8) patch grid shifts its first stage by (0, 2, 2) under
# the mask and clamps the second stage's window to its (2, 4, 4) grid;
# LARS-SGD with ZERO_WD_1D_PARAM, as SwinB_moco_32chips.yaml
SWIN = {"MODEL.ARCH": "swin", "SWIN.EMBED_DIM": 16, "SWIN.DEPTHS": [2, 2], "SWIN.NUM_HEADS": [2, 4],
        "SWIN.WINDOW_SIZE": [2, 4, 4], "SWIN.DROP_PATH_RATE": 0.0, "SOLVER.LARS_ON": True,
        "SOLVER.ZERO_WD_1D_PARAM": True}


def _setup(**overrides):
    jcfg, tcfg = moco_cfg(jconfig, **overrides), moco_cfg(tconfig, **overrides)
    jinit = jbuild_model(jcfg, sync_axes=())
    v = jax.jit(lambda: jinit.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                   jnp.zeros((1, T, S, S, 3), jnp.float32), train=False))()
    params, batch_stats = jax.device_get(v["params"]), jax.device_get(v["batch_stats"])
    ssl = jax.device_get(jc.init_ssl_state(jcfg, params, batch_stats, jax.random.PRNGKey(3)))
    ema = jax.jit(lambda: jinit.init({"params": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(1)},
                                     jnp.zeros((1, T, S, S, 3), jnp.float32), train=False))()
    ssl["ema_params"] = jax.device_get(ema["params"])  # a momentum encoder apart from the online one
    return jcfg, tcfg, params, batch_stats, ssl


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def swin_setup():
    return _setup(**SWIN)


def _port(tcfg, params, batch_stats, ssl):
    conv = convert_train_state(params, batch_stats, ssl=ssl)
    model = build_model(tcfg, "cpu")
    model.load_state_dict(conv["model"])
    tssl = tc.init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    tssl["ema_model"].load_state_dict(conv["ema"])
    tssl["knn_mem"] = conv["knn_mem"].clone()
    tssl["queue_x"] = torch.from_numpy(np.array(ssl["queue_x"]))
    tssl["ptr"] = torch.tensor(int(ssl["ptr"]), dtype=torch.int64)
    model.train()
    tssl["ema_model"].train()
    return model, tssl


def test_init_ssl_state():
    """The momentum encoder, the queue [QUEUE_LEN, DIM] uniform on
    (-stdv, stdv) with stdv = 1 / sqrt(DIM / 3), the pointer at 0 (int64),
    the kNN bank; the same shapes and dtypes as JAX's, except the pointer
    (int32 there)."""
    jcfg, tcfg = moco_cfg(jconfig, **{"CONTRASTIVE.QUEUE_LEN": 4096}), moco_cfg(tconfig, **{
        "CONTRASTIVE.QUEUE_LEN": 4096})
    model = build_model(tcfg, "cpu")
    ssl = tc.init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    jssl = jc.init_ssl_state(jcfg, {}, {}, jax.random.PRNGKey(0))
    assert set(ssl) == {"ema_model", "queue_x", "ptr", "knn_mem"}
    assert set(jssl) == {"ema_params", "ema_batch_stats", "queue_x", "ptr", "knn_mem"}
    stdv = 1.0 / np.sqrt(DIM / 3)
    for name in ("queue_x", "knn_mem"):
        q = ssl[name]
        assert tuple(q.shape) == jssl[name].shape and q.dtype == torch.float32
        assert -stdv <= float(q.min()) < -0.99 * stdv and 0.99 * stdv < float(q.max()) <= stdv
    assert ssl["ptr"].dtype == torch.int64 and int(ssl["ptr"]) == 0 and ssl["ptr"].ndim == 0
    assert all(torch.equal(a, b) for a, b in zip(ssl["ema_model"].state_dict().values(),
                                                  model.state_dict().values()))
    assert not any(p.requires_grad for p in ssl["ema_model"].parameters())
    simclr = tc.init_ssl_state(moco_cfg(tconfig, **{"CONTRASTIVE.TYPE": "simclr"}), model,
                               torch.Generator().manual_seed(0))
    assert set(simclr) == {"knn_mem"} == set(jc.init_ssl_state(
        moco_cfg(jconfig, **{"CONTRASTIVE.TYPE": "simclr"}), {}, {}, jax.random.PRNGKey(0)))


def test_shuffle_round_trip():
    x = torch.arange(24.0).view(8, 3)
    g = torch.Generator().manual_seed(0)
    y, perm = batch_shuffle(x, g)
    assert not torch.equal(y, x) and torch.equal(y, x[perm])
    assert torch.equal(batch_unshuffle(y, perm), x)
    assert torch.equal(torch.sort(perm).values, torch.arange(8))


def test_shuffled_keys_match_jax(setup):
    """The momentum encoder's keys of one view under shuffle-BN, and its
    running statistics after the forward."""
    jcfg, tcfg, params, batch_stats, ssl = setup
    mesh = build_mesh(jcfg, jax.devices()[:1])
    jm = jbuild_model(jcfg)
    x = _clips(1)[:, 1]
    assert tc.shuffle_bn_on(tcfg)

    def keys_fn(s, v, rng):
        keys, ema_bs = jc.compute_keys(jcfg, jm, s, [v], rng)
        return keys[0], ema_bs

    from jax import shard_map

    f = jax.jit(shard_map(keys_fn, mesh=mesh, in_specs=(P(), P(BATCH_AXES), P()),
                          out_specs=(P(BATCH_AXES), P()), check_vma=False))
    keys_j, ema_bs = f(ssl, jnp.asarray(x), jax.random.PRNGKey(0))
    _, tssl = _port(tcfg, params, batch_stats, ssl)
    keys_t = tc.compute_keys(tcfg, tssl, torch.from_numpy(x)[None], torch.Generator().manual_seed(0))
    commit_bn_stats(tssl["ema_model"])
    assert rel_err(keys_t[0], keys_j) <= 1e-4
    own = tssl["ema_model"].state_dict()
    for k, v in batch_stats_to_torch(jax.device_get(ema_bs)).items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("multi_view", [False, True])
def test_dequeue_and_enqueue_matches_jax(multi_view):
    """Writes at the pointer, the pointer's advance and its wrap to 0, the
    first view's keys or every view's; JAX's divisibility check."""
    over = {"CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE": multi_view}
    jcfg, tcfg = moco_cfg(jconfig, **over), moco_cfg(tconfig, **over)
    rng = np.random.default_rng(4)
    queue = rng.standard_normal((QUEUE, DIM)).astype(np.float32)
    jssl = {"queue_x": jnp.asarray(queue), "ptr": jnp.zeros((), jnp.int32)}
    tssl = {"queue_x": torch.from_numpy(queue.copy()), "ptr": torch.zeros((), dtype=torch.int64)}
    ptrs = []
    for i in range(5):
        keys = rng.standard_normal((2, B, DIM)).astype(np.float32)
        jssl = jc.dequeue_and_enqueue(jssl, [jnp.asarray(k) for k in keys], axes=(), multi_view=multi_view)
        tc.dequeue_and_enqueue(tcfg, tssl, torch.from_numpy(keys))
        np.testing.assert_array_equal(tssl["queue_x"].numpy(), np.asarray(jssl["queue_x"]))
        assert int(tssl["ptr"]) == int(jssl["ptr"])
        ptrs.append(int(tssl["ptr"]))
    step = 2 * B if multi_view else B
    assert ptrs == [(step * (i + 1)) % QUEUE for i in range(5)]
    assert 0 in ptrs  # the wrap
    with pytest.raises(ValueError, match="divisible"):
        tc.dequeue_and_enqueue(tcfg, tssl, torch.zeros(2, 3, DIM))
    with pytest.raises(AssertionError):
        jc.dequeue_and_enqueue(jssl, [jnp.zeros((3, DIM))] * 2, axes=())


def test_moco_loss_and_grads_match_jax(setup):
    """The loss over [positive, queue] logits, acc_ins, the gradients, both
    models' running statistics, the queue and the kNN bank after the step's
    writes. JAX's loss outside shard_map has no shuffle (PARTITION_MODE
    'auto', collectives the identity); the port shuffles: the same keys."""
    jcfg, tcfg, params, batch_stats, ssl = setup
    jcfg = jcfg.clone()
    jcfg.TPU.PARTITION_MODE = "auto"
    jm = jbuild_model(jcfg, sync_axes=())
    x = _clips(2)
    infos = {"item_id": np.arange(B, dtype=np.int32) * 5 + 2}

    def loss_fn(p, s):
        loss, bs, new_ssl, stats = jc.moco_loss(jcfg, jm, p, batch_stats, s, [x[:, 0], x[:, 1]], infos,
                                                jax.random.PRNGKey(0))
        return loss, (bs, new_ssl, stats)

    (loss_j, (bs_j, ssl_j, stats_j)), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, ssl)
    model, tssl = _port(tcfg, params, batch_stats, ssl)
    loss_t, tssl, stats_t = tc.moco_loss(tcfg, model, tssl, torch.from_numpy(x).transpose(0, 1),
                                         {"item_id": torch.from_numpy(infos["item_id"]).long()},
                                         torch.Generator().manual_seed(0))
    loss_t.backward()
    commit_bn_stats(model)
    commit_bn_stats(tssl["ema_model"])
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert float(stats_t["acc_ins"]) == float(stats_j["acc_ins"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    g_ref = params_to_torch(jax.device_get(g_j))
    top = max(float(v.abs().max()) for v in g_ref.values())
    for k, v in g_ref.items():
        assert float((grads[k] - v).abs().max()) <= 1e-2 * top, k
    for mod, ref in ((model, bs_j), (tssl["ema_model"], ssl_j["ema_batch_stats"])):
        own = mod.state_dict()
        for k, v in batch_stats_to_torch(jax.device_get(ref)).items():
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
    assert int(tssl["ptr"]) == int(ssl_j["ptr"]) == B
    for name in ("queue_x", "knn_mem"):
        assert float((tssl[name] - torch.from_numpy(np.array(ssl_j[name]))).abs().max()) <= 1e-4, name


def test_three_step_trajectory_matches_jax(setup):
    """The contrastive step (EMA update, moco_loss with shuffle-BN, the
    queue, kNN scatter, SGD) 3 times from the same state, the
    augmentation held apart; with QUEUE_LEN 16 and 4 keys a step the
    pointer runs 4, 8, 12."""
    _trajectory(setup)


def test_swin_three_step_trajectory_matches_jax(swin_setup):
    """The same 3 steps over the small Swin (SWIN): the loss, acc_ins, the
    grad norm, what each parameter, BN statistic and momentum-encoder
    tensor moved, the queue and its pointer, with the tolerances above;
    the MLP projector's BN (bn0) under shuffle-BN in the keys."""
    tcfg, batch_stats = swin_setup[1], swin_setup[3]
    assert type(build_model(tcfg, "cpu").backbone).__name__ == "SwinTransformer3D"
    assert set(batch_stats_to_torch(batch_stats)) == {"backbone.head.projection.bn0.running_mean",
                                                      "backbone.head.projection.bn0.running_var"}
    _trajectory(swin_setup)


def _trajectory(setup):
    jcfg, tcfg, params, batch_stats, ssl = setup
    mesh = build_mesh(jcfg, jax.devices()[:1])
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats=batch_stats, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32), ssl=ssl), mesh)
    model, tssl = _port(tcfg, params, batch_stats, ssl)
    named = dict(model.named_parameters())
    tbundle = build_tx(tcfg, named)
    tstate = TrainState(model, tbundle.tx.init(named), 0, tssl)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    tstep = make_train_step(tcfg, tbundle, None)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        ids = np.arange(B, dtype=np.int32) * 3 + i
        jstate, jstats = jstep(jstate, jnp.asarray(_clips(10 + i)), {"item_id": ids}, jax.random.PRNGKey(i),
                               jnp.float32(LR), jnp.float32(0.5))
        tstats = tstep(tstate, torch.from_numpy(_clips(10 + i)), {"item_id": torch.from_numpy(ids).long()},
                       gen, LR, 0.5)
        assert set(tstats) == {"loss_nce", "acc_ins", "grad_norm"}
        assert abs(tstats["loss_nce"].item() - float(jstats["loss_nce"])) <= 1e-4 * abs(float(jstats["loss_nce"]))
        assert tstats["acc_ins"].item() == float(jstats["acc_ins"])
        assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
        assert int(tstate.ssl["ptr"]) == int(jstate.ssl["ptr"]) == (i + 1) * B
    jstate = jax.device_get(jstate)
    p0, bs0 = params_to_torch(params), batch_stats_to_torch(batch_stats)
    ema0 = params_to_torch(ssl["ema_params"])
    for got, want, init in ((model.state_dict(), params_to_torch(jstate.params), p0),
                            (model.state_dict(), batch_stats_to_torch(jstate.batch_stats), bs0),
                            (tssl["ema_model"].state_dict(), params_to_torch(jstate.ssl["ema_params"]), ema0),
                            (tssl["ema_model"].state_dict(), batch_stats_to_torch(jstate.ssl["ema_batch_stats"]),
                             bs0)):
        top = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            g, w, i0 = (np.asarray(a, np.float32) for a in (got[k], v, init[k]))
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w - i0).max() + 1e-6 * top, k
    for name in ("queue_x", "knn_mem"):
        assert float((tssl[name] - torch.from_numpy(np.array(jstate.ssl[name]))).abs().max()) <= 1e-3, name


def test_knn_probe_on_batch_statistics_matches_jax(setup):
    """CONTRASTIVE.KNN_BATCH_STATS: the first view in train mode (the
    batch's BN statistics) against a bank that holds JAX's train-mode
    features of the same batch, with labels that only those features can
    win: the same accuracy as JAX's probe; the model's running statistics
    untouched and no BN record left for the next step."""
    jcfg, tcfg, params, batch_stats, ssl = setup
    mesh = build_mesh(jcfg, jax.devices()[:1])
    x = _clips(20)
    jm = jbuild_model(jcfg, sync_axes=())
    out, _ = jm.apply({"params": params, "batch_stats": batch_stats}, jnp.asarray(x[:, 0]), train=True,
                      mutable=["batch_stats"])
    q = np.asarray(jc.l2_normalize(out[0] if isinstance(out, (list, tuple)) else out))
    bank = np.random.default_rng(5).standard_normal((32, DIM)).astype(np.float32) * 0.01
    bank[:B] = q
    labels = np.full(32, 3, np.int32)
    labels[:B] = np.arange(B) % 3
    cls = (np.arange(B) % 3).astype(np.int32)
    jssl = dict(ssl, knn_mem=bank, knn_labels=labels)
    want = jmake_probe(jcfg, mesh, jbuild_model(jcfg), None, num_classes=4)(
        params, batch_stats, jssl, jnp.asarray(x), {"cls_id": cls}, jax.random.PRNGKey(0))
    model, tssl = _port(tcfg, params, batch_stats, ssl)
    tssl["knn_mem"], tssl["knn_labels"] = torch.from_numpy(bank), torch.from_numpy(labels)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    probe = make_knn_probe_step(tcfg, None, num_classes=4)
    got = probe(TrainState(model, {}, 0, tssl), torch.from_numpy(x), {"cls_id": torch.from_numpy(cls)},
                torch.Generator().manual_seed(0))
    assert float(got) == float(want) == 1.0
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert all(not m.pending for m in model.modules() if isinstance(m, SyncBatchNorm))
    # in eval mode (the running statistics of a fresh model) the features miss the bank
    ecfg = moco_cfg(tconfig, **{"CONTRASTIVE.KNN_BATCH_STATS": False})
    assert float(make_knn_probe_step(ecfg, None, num_classes=4)(
        TrainState(model, {}, 0, tssl), torch.from_numpy(x), {"cls_id": torch.from_numpy(cls)}, None)) < 1.0


@pytest.mark.parametrize("ctype", ["byol", "moco", "simclr", "swav", "mem"])
def test_every_contrastive_type_builds_its_step(ctype):
    """Each CONTRASTIVE.TYPE of the JAX package builds its contrastive step
    and its state: the momentum encoder for byol and moco only, the queue
    for moco, the bank for mem, and for swav the prototypes."""
    from advise_tpu_torch.engine.steps import make_contrastive_train_step

    cfg = moco_cfg(tconfig, **{"CONTRASTIVE.TYPE": ctype})
    assert callable(make_contrastive_train_step(cfg, None, None))
    model = build_model(cfg, "cpu")
    ssl = tc.init_ssl_state(cfg, model, torch.Generator().manual_seed(0))
    assert ("ema_model" in ssl) == (ctype in ("byol", "moco"))
    assert ("queue_x" in ssl) == (ctype == "moco") and ("memory" in ssl) == (ctype == "mem")
    assert hasattr(model, "swav_prototypes") == (ctype == "swav")
