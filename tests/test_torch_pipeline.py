"""The port's GPipe over 'pipe' (``parallel/pipeline.py``, MViT's pipelined
segments) at 4 gloo ranks against the JAX package on its CPU mesh, every
case in one spawn (``tests/torch_dist_workers.py``: a ``file://``
rendezvous in the tmp dir, a process-group timeout, a join deadline).

- ``gpipe`` of y = tanh(... tanh(x @ w_0) ... @ w_7), 4 stages of 2 blocks,
  a batch of 4, with ``sync_cotangents`` on w and x, at n_micro 1, 2 and 4
  against JAX's ``gpipe`` on a ('pipe',) mesh of 4 devices (float32): the
  output within 1e-6 of JAX's, the gradients of sum(y^2) within 1e-5 of
  the largest, the same on every rank (replicated);
- the microbatch index reaches every stage: h + m over 4 stages and 4
  microbatches of one row gives row r = 4 r, as JAX's test asks;
- JAX's rejections: a batch the microbatches do not divide, a stack the
  stages do not divide, a pipe size that divides no reversible segment (the
  model's AssertionError), and the config's (MESH_PIPE without REV, on a
  ContrastiveModel, with MESH_SEQ) raise as JAX's do;
- MaskMViT's joint step (``torch_port_common.masked_cfg`` at depth 7: a
  4-block reversible segment, PIPE_MICROBATCH 0: 4 microbatches of one
  clip over 4 stages) at TPU.MESH_PIPE 4 for 2 steps against JAX's
  one-device step on the same batch (MVIT.DROPPATH_RATE 0): stats within
  1e-3 of max(|JAX's|, 1), grad norm within 1e-2, each parameter's move
  within 5e-2 of JAX's plus 1e-6 of the tree's largest value (lr 1e-4);
- the same step with MVIT.DROPPATH_RATE 0.3 at pipe 4 against JAX's
  pipelined step (pipe 4 on a ('data', 'sync', 'pipe') mesh of 4 devices),
  the port handed JAX's drop-path draws: the test records every
  ``jax.random.bernoulli`` and ``jax.random.fold_in`` of JAX's step
  (``jax.debug.callback``), tells each block by its rate, a reversible
  block's attention and MLP draws and the microbatch m by the keys they were
  folded from, and gives the port microbatch m's masks as rows m of its
  whole-batch masks; the trajectory bounds above;
- the same step with MVIT.DROPPATH_RATE 0.3 at pipe 4 against the
  unpipelined step of the same 4 ranks (MESH_SEQ 4, SEQ_SHARD False: the
  same batch and the same draws on every rank): stats within 1e-5 of
  max(|v|, 1) and each parameter within 1e-5 of the largest: microbatch m
  takes rows m of the keep masks drawn for the whole batch, so the
  pipelined step is the plain one row for row (JAX folds m into its keys
  instead, so its pipelined draws differ from its plain ones; each row is
  an independent draw in both).
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
from advise_tpu.parallel import build_mesh
from advise_tpu.parallel.pipeline import PIPE_AXIS, gpipe, sync_cotangents
from advise_tpu.solver import build_tx as jbuild_tx
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.parallel import pipeline as tpipe
from advise_tpu_torch.utils.convert import params_to_torch

import torch_dist_workers as workers
from torch_port_common import _override, loader_masks, masked_cfg, masked_variables, moved_within, on_mesh

WORLD = 4
DEADLINE_S = 240.0
LR = float(np.float32(1e-4))
DEPTH, B, D = 8, 4, 6
PIPE_STEP = {"TPU.FLASH_ATTENTION": False, "MVIT.DEPTH": 7, "MASK.PRETRAIN_DEPTH": [6]}
PIPE_DROP = 0.3


def _pipe_cfg(**overrides):
    cfg = tconfig.get_cfg()
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    _override(cfg, {"TPU.MESH_PIPE": WORLD, **overrides})
    return cfg


def _gpipe_ref(n_micro):
    rng = np.random.default_rng(n_micro)
    w = (rng.standard_normal((DEPTH, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), (PIPE_AXIS,))

    def run(w, x):
        w, x = sync_cotangents((w, x))
        s = jax.lax.axis_index(PIPE_AXIS)
        local = DEPTH // WORLD
        w_loc = jax.lax.dynamic_slice_in_dim(w, s * local, local, 0)

        def stage(h, _m):
            for k in range(local):
                h = jnp.tanh(h @ w_loc[k])
            return h

        return gpipe(stage, x, n_stage=WORLD, n_micro=n_micro)

    def loss(w, x):
        y = shard_map(run, mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False)(w, x)
        return (y ** 2).sum(), y

    (_, y), (gw, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(w, x)
    probe = jax.jit(shard_map(lambda h: gpipe(lambda a, m: a + m.astype(a.dtype), h, n_stage=WORLD, n_micro=WORLD),
                              mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False))(jnp.zeros((WORLD, 2)))
    case = {"kind": "fn", "fn": "gpipe_case", "cfg": _pipe_cfg(), "w": w, "x": x, "n_micro": n_micro}
    return case, {"y": np.asarray(y), "w_grad": np.asarray(gw), "x_grad": np.asarray(gx), "probe": np.asarray(probe)}


def _batches(tcfg):
    steps = []
    for i in range(2):
        rng = np.random.default_rng(200 + i)
        masks = loader_masks(tcfg, 4, seed=10 + i)
        steps.append({"clips": rng.standard_normal((2, 2, 4, 28, 28, 3)).astype(np.float32),
                      "infos": {"mask": masks.reshape(2, 2, *masks.shape[1:])}})
    return steps


def _jax_drop_masks(folds, berns, depth):
    """The port's drop-path masks of one step, {block: (attention's, MLP's)}
    for a reversible block and (mask,) for a transition (None at rate 0),
    from JAX's draws in that step: ``berns`` (key, keep probability, mask)
    of each ``jax.random.bernoulli``, ``folds`` (key, data, key) of each
    ``jax.random.fold_in``. A block is told by its rate (a linspace: one
    a block); a reversible block's draw by its key, split from fold_in(c,
    0) (attention) or fold_in(c, 1) (MLP), where c is the block's key, in a
    pipelined segment folded with the microbatch m. Microbatch m's masks
    become rows m of the whole batch's."""
    dpr = np.linspace(0.0, PIPE_DROP, depth)
    split = {}
    for parent, data, key in folds:
        if data in (0, 1):
            split[tuple(np.asarray(jax.random.split(jnp.asarray(key, jnp.uint32)))[1].ravel())] = (parent, data)
    micro = {key: data for _, data, key in folds}
    parts = {}
    for key, keep, mask in berns:
        block = int(np.abs(1.0 - keep - dpr).argmin())
        parent, sub = split.get(key, (None, 0))
        m = micro.get(parent, 0) if parent is not None else 0
        got = parts.setdefault((block, sub), {}).setdefault(m, mask)
        assert np.array_equal(got, mask), (block, sub, m)  # a recomputation or a bubble tick draws the same
    keeps = {}
    for (block, sub), by_m in sorted(parts.items()):
        whole = np.concatenate([by_m[m] for m in sorted(by_m)]).astype(bool)
        keeps.setdefault(block, []).append(None if dpr[block] == 0 else torch.from_numpy(whole))
    return {block: tuple(subs) for block, subs in keeps.items()}


def _jax_pipe_drop_steps(params, steps):
    """JAX's pipelined step (pipe 4 on 4 devices, drop path PIPE_DROP) over
    ``steps``: each step's stats, the final params and each step's draws as
    the port's masks (:func:`_jax_drop_masks`)."""
    jcfg = masked_cfg(jconfig, **PIPE_STEP, **{"MVIT.DROPPATH_RATE": PIPE_DROP, "TPU.MESH_PIPE": WORLD})
    mesh = build_mesh(jcfg, jax.devices()[:WORLD])
    bundle = jbuild_tx(jcfg, params)
    state = on_mesh(JState(params=params, batch_stats={}, opt_state=bundle.tx.init(params),
                           step=jnp.zeros((), jnp.int32)), mesh)
    step = jmake_step(jcfg, mesh, jbuild_model(jcfg), bundle, None)
    folds, berns = [], []
    fold_in, bernoulli = jax.random.fold_in, jax.random.bernoulli

    def data(key):
        return jax.random.key_data(key) if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key) else key

    def row(a):
        return tuple(np.asarray(a).ravel())

    def fold_spy(key, d):
        out = fold_in(key, d)
        jax.debug.callback(lambda a, dd, b: folds.append((row(a), int(dd), row(b))), data(key),
                           jnp.asarray(d, jnp.uint32), data(out))
        return out

    def bernoulli_spy(key, p=0.5, shape=None):
        out = bernoulli(key, p, shape)
        jax.debug.callback(lambda a, pp, mask: berns.append((row(a), float(pp), np.asarray(mask).ravel().copy())),
                           data(key), jnp.asarray(p, jnp.float32), out)
        return out

    stats, keeps = [], []
    jax.random.fold_in, jax.random.bernoulli = fold_spy, bernoulli_spy
    try:
        for i, inp in enumerate(steps):
            folds.clear()
            berns.clear()
            state, st = step(state, jnp.asarray(inp["clips"]), {k: jnp.asarray(v) for k, v in inp["infos"].items()},
                             jax.random.PRNGKey(i), jnp.float32(LR))
            jax.effects_barrier()
            stats.append({k: float(v) for k, v in st.items()})
            keeps.append(_jax_drop_masks(folds, berns, jcfg.MVIT.DEPTH))
    finally:
        jax.random.fold_in, jax.random.bernoulli = fold_in, bernoulli
    return stats, jax.device_get(state.params), keeps


def _step_cases():
    """The pipelined step against JAX's one-device step, and the drop-path
    pair (pipelined, plain) of the port alone."""
    jcfg = masked_cfg(jconfig, **PIPE_STEP)
    tcfg = masked_cfg(tconfig, **PIPE_STEP, **{"TPU.MESH_PIPE": WORLD, "NUM_GPUS": WORLD})
    params = masked_variables(jbuild_model(jcfg, sync_axes=()))
    steps = _batches(tcfg)
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
    model = params_to_torch(params)
    common = {"kind": "steps", "model": model, "ema": {}, "ssl": {}, "steps": steps, "lr": LR, "epoch": 0.5}
    drop = {"MVIT.DROPPATH_RATE": PIPE_DROP, "NUM_GPUS": WORLD}
    dstats, dparams, keeps = _jax_pipe_drop_steps(params, steps)
    cases = {
        "step": ({**common, "cfg": tcfg},
                 {"params0": model, "params": params_to_torch(jax.device_get(jstate.params)), "stats": jstats}),
        "step_drop_jax": ({**common, "cfg": masked_cfg(tconfig, **PIPE_STEP, **drop, **{"TPU.MESH_PIPE": WORLD}),
                           "steps": [{**inp, "keeps": k} for inp, k in zip(steps, keeps)]},
                          {"params0": model, "params": params_to_torch(dparams), "stats": dstats}),
        "step_drop_pipe": ({**common, "cfg": masked_cfg(tconfig, **PIPE_STEP, **drop, **{"TPU.MESH_PIPE": WORLD})},
                           None),
        "step_drop_plain": ({**common, "cfg": masked_cfg(tconfig, **PIPE_STEP, **drop, **{
            "TPU.MESH_SEQ": WORLD, "MVIT.SEQ_SHARD": False})}, None),
    }
    none_cfg = masked_cfg(tconfig, **{**PIPE_STEP, "MVIT.DEPTH": 6, "MASK.PRETRAIN_DEPTH": [5],
                                      "TPU.MESH_PIPE": WORLD, "NUM_GPUS": WORLD})
    cases["divides_none"] = ({"kind": "fn", "fn": "divides_none_case", "cfg": none_cfg,
                              "shape": (1, 4, 28, 28, 3), "mask_shape": (1, 2 * 7 * 7)}, None)
    return cases


@pytest.fixture(scope="module")
def pipe_world(tmp_path_factory):
    """{case: (JAX's reference or None, each rank's output)}, one spawn."""
    tmp = tmp_path_factory.mktemp("pipe")
    cases = {f"gpipe{m}": _gpipe_ref(m) for m in (1, 2, 4)}
    cases.update(_step_cases())
    for name, (case, _) in cases.items():
        torch.save(case, tmp / f"case_{name}.pt")
    workers.spawn_ranks(workers.model_parallel_worker, WORLD, (str(tmp), list(cases)), DEADLINE_S)
    return {name: (ref, [torch.load(tmp / f"out_{name}_{r}.pt", weights_only=False) for r in range(WORLD)])
            for name, (_, ref) in cases.items()}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max()) + 1e-7


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_gpipe_matches_jax(pipe_world, n_micro):
    ref, outs = pipe_world[f"gpipe{n_micro}"]
    for out in outs:
        np.testing.assert_allclose(out["y"].numpy(), ref["y"], atol=1e-6)
        assert _close(out["w_grad"].numpy(), ref["w_grad"], 1e-5)
        assert _close(out["x_grad"].numpy(), ref["x_grad"], 1e-5)
        assert torch.equal(out["w_grad"], outs[0]["w_grad"]) and torch.equal(out["x_grad"], outs[0]["x_grad"])


def test_gpipe_microbatch_index_reaches_every_stage(pipe_world):
    ref, outs = pipe_world["gpipe4"]
    expect = np.repeat(np.arange(4.0) * WORLD, 2).reshape(4, 2)
    np.testing.assert_allclose(ref["probe"], expect)
    for out in outs:
        np.testing.assert_allclose(out["probe"].numpy(), expect)


def test_jax_rejections_raise_in_the_port(pipe_world):
    with pytest.raises(AssertionError, match="not divisible"):
        tpipe.gpipe(lambda h, m: h, (torch.ones(4, 2),), n_stage=2, n_micro=3)
    with pytest.raises(AssertionError, match="not divisible"):
        tpipe.stage_slice(list(range(6)), 4)
    for out in pipe_world["divides_none"][1]:
        assert out["error"] is not None and "divides none" in out["error"]
    for over, match in (({"MVIT.REV.ENABLE": False}, "MVIT.REV.ENABLE"),
                        ({"MODEL.MODEL_NAME": "ContrastiveModel"}, "supports MViT/MaskMViT"),
                        ({"TPU.MESH_SEQ": 2}, "mutually exclusive")):
        for mod in (jconfig, tconfig):
            with pytest.raises(AssertionError, match=match):
                masked_cfg(mod, **{"TPU.MESH_PIPE": 2, **over})


def _holds_to_jax(ref, outs):
    """The trajectory bounds (module docstring), the ranks bit for bit."""
    first = outs[0]
    for st_t, st_j in zip(first["stats"], ref["stats"]):
        for key, v in st_j.items():
            tol = 1e-2 if key == "grad_norm" else 1e-3
            assert abs(st_t[key] - v) <= tol * max(abs(v), 1.0), (key, st_t[key], v)
    assert not moved_within(first["model"], ref["params"], ref["params0"])
    for out in outs[1:]:
        for key in first["model"]:
            assert torch.equal(out["model"][key], first["model"][key]), key


def test_pipelined_step_matches_the_jax_step(pipe_world):
    _holds_to_jax(*pipe_world["step"])


def test_pipelined_drop_path_matches_jax_given_its_draws(pipe_world):
    _holds_to_jax(*pipe_world["step_drop_jax"])


def test_pipelined_drop_path_is_the_plain_step(pipe_world):
    _, piped = pipe_world["step_drop_pipe"]
    _, plain = pipe_world["step_drop_plain"]
    for st_p, st_q in zip(piped[0]["stats"], plain[0]["stats"]):
        for key, v in st_q.items():
            assert abs(st_p[key] - v) <= 1e-5 * max(abs(v), 1.0), (key, st_p[key], v)
    top = max(float(t.abs().max()) for t in plain[0]["model"].values())
    for key, want in plain[0]["model"].items():
        assert float((piped[0]["model"][key] - want).abs().max()) <= 1e-5 * top, key
