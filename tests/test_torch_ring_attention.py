"""The port's sequence parallelism (``parallel/ring_attention.py``, the
attention's seq branch) at 2 and 4 gloo ranks against the JAX package on
its CPU mesh, one spawn a world (``tests/torch_dist_workers.py``: a
``file://`` rendezvous in the tmp dir, a process-group timeout, a join
deadline).

Cases, float32:

- ``sequence_sharded_attention`` on whole [2, 3, 8n, 4] q, k, v (n ranks)
  against JAX's over a ('seq',) mesh of n devices: the output within 2e-5;
  the inputs' gradients of sum(out * w), the mean over the ranks (each
  rank's is its slice's times n: the gather's backward sums, as JAX
  transposes ``all_gather``), within 1e-4 of the largest gradient;
- MultiScaleAttention with seq_axis 'seq' (16 wide, 2 heads, a 2 x 4 x 4
  grid), square (the ring), q and kv pooled alike to 2 x 2 x 2 (the ring
  on pooled tokens, as MViT-L's block 8) and pooled-KV (the q slice
  against the whole k and v): the output within 2e-5 of JAX's seq branch
  under ``shard_map`` and of its dense path, the parameters' and input's
  gradients (mean over the ranks) within 1e-4 of the largest of JAX's
  dense path's. JAX's own seq branch has each rank's gradient right only
  in the mean over 'seq' (its step averages over ('data', 'sync') and keeps
  one rank's); the port's step averages over the world;
- at 2 ranks, the trainer (``engine/train.py``, what ``tools.run`` calls)
  on the MViT-L joint preset cut to CPU size (depth 7, one epoch of 2
  synthetic videos) under TPU.MESH_SEQ 2, TPU.MESH_PIPE 2 and 'auto' with
  MESH_MODEL 2 and FSDP: the three runs' stats equal within 1e-5 of
  max(|v|, 1) (the batch is replicated in all three, so they are one
  computation), both ranks end with the same model digest, only rank 0
  writes checkpoints;
- at 2 ranks, MaskMViT's joint step (``torch_port_common.masked_cfg``,
  every block on the seq branch: SEQ_SHARD_MIN_TOKENS 1) at TPU.MESH_SEQ 2
  for 2 steps against JAX's one-device step on the same batch: each step's
  stats within 1e-3 of max(|JAX's|, 1), grad norm within 1e-2 of it, what
  each parameter moved within 5e-2 of JAX's move plus 1e-6 of the tree's
  largest value (lr 1e-4); both ranks end bit for bit alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from advise_tpu import config as jconfig
from advise_tpu.engine.state import TrainState as JState
from advise_tpu.engine.steps import make_train_step as jmake_step
from advise_tpu.models import build_model as jbuild_model
from advise_tpu.models.layers.attention import MultiScaleAttention as JAttention
from advise_tpu.parallel import build_mesh
from advise_tpu.parallel.mesh import SEQ_AXIS
from advise_tpu.parallel.ring_attention import sequence_sharded_attention
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.utils.convert import params_to_torch

import torch_dist_workers as workers
from torch_port_common import loader_masks, masked_cfg, masked_variables, moved_within, on_mesh

DEADLINE_S = 240.0
LR = float(np.float32(1e-4))
THW = (2, 4, 4)
# (name, JAX's kwargs beside dim_out 16, 2 heads, qkv bias, no cls token, conv pools)
ATTENTIONS = {
    "square": {},
    "pooled_alike": {"kernel_q": (3, 3, 3), "stride_q": (1, 2, 2), "kernel_kv": (3, 3, 3), "stride_kv": (1, 2, 2)},
    "pooled_kv": {"kernel_kv": (3, 3, 3), "stride_kv": (1, 2, 2)},
}
SEQ_STEP = {"TPU.FLASH_ATTENTION": False, "MVIT.SEQ_SHARD_MIN_TOKENS": 1}


def _seq_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), (SEQ_AXIS,))


def _ring_ref(n, rng):
    q, k, v, w = (rng.standard_normal((2, 3, 8 * n, 4)).astype(np.float32) for _ in range(4))
    mesh = _seq_mesh(n)

    def loss(q, k, v):
        out = sequence_sharded_attention(q, k, v, mesh, SEQ_AXIS)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    case = {"kind": "fn", "fn": "ring_case", "cfg": _layout_cfg(n), "q": q, "k": k, "v": v, "w": w}
    return case, {"out": np.asarray(out), "grads": [np.asarray(g) for g in grads]}


def _attention_ref(n, name, rng):
    kw = dict(dim_out=16, num_heads=2, input_size=THW, qkv_bias=True, has_cls_embed=False, mode="conv",
              **ATTENTIONS[name])
    dense, ring = JAttention(**kw, seq_axis=None), JAttention(**kw, seq_axis=SEQ_AXIS)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    variables = dense.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), THW, True)
    out = np.asarray(dense.apply(variables, x, THW, True)[0])
    w = rng.standard_normal(out.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(dense.apply(p, xx, THW, True)[0] * w)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables, x)
    seq_out = jax.jit(shard_map(lambda p, xx: ring.apply(p, xx, THW, True)[0], mesh=_seq_mesh(n),
                                in_specs=(P(), P()), out_specs=P(), check_vma=False))(variables, x)
    kwargs = {"dim": 16, "dim_out": 16, "num_heads": 2, "qkv_bias": True, "has_cls_embed": False,
              "mode": "conv", **ATTENTIONS[name]}
    case = {"kind": "fn", "fn": "attention_case", "cfg": _layout_cfg(n), "kwargs": kwargs, "thw": THW, "x": x,
            "w": w, "params": params_to_torch(jax.device_get(variables["params"]))}
    return case, {"out": out, "seq_out": np.asarray(seq_out), "grads": params_to_torch(jax.device_get(g_params["params"])),
                  "x_grad": np.asarray(g_x)}


def _layout_cfg(n, **overrides):
    cfg = tconfig.get_cfg()
    cfg.TPU.MESH_SEQ = n
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return cfg


def _step_ref():
    """MaskMViT's joint step: the port's case at MESH_SEQ 2 and JAX's
    one-device trajectory on the same batches."""
    jcfg = masked_cfg(jconfig, **SEQ_STEP)
    tcfg = masked_cfg(tconfig, **SEQ_STEP, **{"TPU.MESH_SEQ": 2, "NUM_GPUS": 2})
    params = masked_variables(jbuild_model(jcfg, sync_axes=()))
    steps = []
    for i in range(2):
        rng = np.random.default_rng(100 + i)
        clips = rng.standard_normal((2, 2, 4, 28, 28, 3)).astype(np.float32)
        masks = loader_masks(tcfg, 4, seed=i)
        steps.append({"clips": clips, "infos": {"mask": masks.reshape(2, 2, *masks.shape[1:])}})
    mesh = build_mesh(jcfg, jax.devices()[:1])
    bundle = jbuild_tx(jcfg, params)
    jstate = on_mesh(JState(params=params, batch_stats={}, opt_state=bundle.tx.init(params),
                            step=jnp.zeros((), jnp.int32)), mesh)
    jstep = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    jstats = []
    for i, inp in enumerate(steps):
        jstate, st = jstep(jstate, jnp.asarray(inp["clips"]), {k: jnp.asarray(v) for k, v in inp["infos"].items()},
                           jax.random.PRNGKey(i), jnp.float32(LR))
        jstats.append({k: float(v) for k, v in st.items()})
    case = {"kind": "steps", "cfg": tcfg, "model": params_to_torch(params), "ema": {}, "ssl": {}, "steps": steps,
            "lr": LR, "epoch": 0.5}
    return case, {"params0": params_to_torch(params), "params": params_to_torch(jax.device_get(jstate.params)),
                  "stats": jstats}


TRAINER_LAYOUTS = {"seq": {"TPU.MESH_SEQ": 2}, "pipe": {"TPU.MESH_PIPE": 2},
                   "auto": {"TPU.PARTITION_MODE": "auto", "TPU.MESH_MODEL": 2, "TPU.FSDP": True}}


def _trainer_cases(tmp):
    from torch_port_common import run_cfg

    over = {"MVIT.EMBED_DIM": 8, "MVIT.DEPTH": 7, "MVIT.DIM_MUL": [[2, 2.0]], "MVIT.HEAD_MUL": [[2, 2.0]],
            "MVIT.POOL_Q_STRIDE": [[2, 1, 2, 2]], "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 4, 4],
            "MASK.PRETRAIN_DEPTH": [6], "CONTRASTIVE.DIM": 16, "CONTRASTIVE.MLP_DIM": 32,
            "DATA.TRAIN_CROP_SIZE": 28, "DATA.TEST_CROP_SIZE": 28, "AUG.TARGET_SIZE": 28,
            "DATA.BATCHSIZE_PER_GPU": 1, "DATA.SYNTHETIC_SIZE": 2, "SOLVER.MAX_EPOCH": 1,
            "TPU.FLASH_ATTENTION": False, "MVIT.SEQ_SHARD_MIN_TOKENS": 1, "NUM_GPUS": 2}
    return {f"trainer_{name}": ({"kind": "fn", "fn": "trainer_case", "cfg": run_cfg(
        "configs/pretrain/MViT_L_32x312_joint.yaml", tmp / name, **over, **layout)}, None)
        for name, layout in TRAINER_LAYOUTS.items()}


_WORLDS = {}


@pytest.fixture(scope="module")
def seq_world(tmp_path_factory):
    """``seq_world(n)``: {case: (JAX's reference, each rank's output)} at n
    ranks, every case of a world in one spawn, made once a module."""

    def run(n):
        if n not in _WORLDS:
            tmp = tmp_path_factory.mktemp(f"seq{n}")
            rng = np.random.default_rng(n)
            cases = {"ring": _ring_ref(n, rng)}
            for name in ATTENTIONS:
                cases[name] = _attention_ref(n, name, rng)
            if n == 2:
                cases["step"] = _step_ref()
                cases.update(_trainer_cases(tmp))
            for name, (case, _) in cases.items():
                torch.save(case, tmp / f"case_{name}.pt")
            workers.spawn_ranks(workers.model_parallel_worker, n, (str(tmp), list(cases)), DEADLINE_S)
            _WORLDS[n] = {name: (ref, [torch.load(tmp / f"out_{name}_{r}.pt", weights_only=False)
                                       for r in range(n)]) for name, (_, ref) in cases.items()}
        return _WORLDS[n]

    return run


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max()) + 1e-6


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_sequence_sharded_attention(seq_world, n):
    ref, outs = seq_world(n)["ring"]
    for out in outs:
        np.testing.assert_allclose(out["out"].numpy(), ref["out"], atol=2e-5, rtol=2e-5)
    for i, want in enumerate(ref["grads"]):
        mean = torch.stack([out["grads"][i] for out in outs]).mean(0).numpy()
        assert _close(mean, want, 1e-4), (n, "qkv"[i])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(ATTENTIONS))
def test_seq_branch_matches_jax(seq_world, n, name):
    ref, outs = seq_world(n)[name]
    np.testing.assert_allclose(ref["seq_out"], ref["out"], atol=2e-5, rtol=2e-5)  # JAX's own branch
    for out in outs:
        np.testing.assert_allclose(out["out"].numpy(), ref["seq_out"], atol=2e-5, rtol=2e-5)
    for key, want in ref["grads"].items():
        mean = torch.stack([out["grads"][key] for out in outs]).mean(0).numpy()
        assert _close(mean, want.numpy(), 1e-4), (n, name, key)
    assert _close(torch.stack([out["x_grad"] for out in outs]).mean(0).numpy(), ref["x_grad"], 1e-4)


def test_seq_mesh_step_matches_the_jax_step(seq_world):
    ref, outs = seq_world(2)["step"]
    first = outs[0]
    for st_t, st_j in zip(first["stats"], ref["stats"]):
        for key, v in st_j.items():
            tol = 1e-2 if key == "grad_norm" else 1e-3
            assert abs(st_t[key] - v) <= tol * max(abs(v), 1.0), (key, st_t[key], v)
    assert not moved_within(first["model"], ref["params"], ref["params0"])
    for key in first["model"]:
        assert torch.equal(outs[1]["model"][key], first["model"][key]), key


def test_trainer_runs_each_layout(seq_world):
    res = seq_world(2)
    first = res["trainer_seq"][1][0]["stats"]
    for name in TRAINER_LAYOUTS:
        ranks = [out for out in res[f"trainer_{name}"][1]]
        assert ranks[0]["world"] == 2 and len(ranks[0]["stats"]) == 2, name
        for st, want in zip(ranks[0]["stats"], first):
            for key, v in want.items():
                assert abs(st[key] - v) <= 1e-5 * max(abs(v), 1.0), (name, key, st[key], v)
        assert ranks[0]["model_sha256_end"] == ranks[1]["model_sha256_end"], name
        assert ranks[0]["saves"] and not ranks[1]["saves"], name
