"""The port's memory bank (advise_tpu_torch/engine/contrastive.py:
init_ssl_state, _mem_interp_weights, mem_loss) against the JAX package's,
on configs/chip/moco_knn_minik400.yaml cut to a Slow R10 with CONTRASTIVE.TYPE
mem (tests/torch_port_common.py ``contrastive_cfg``): MEM_TYPE 1d, 2d at
DURATION 4, and 2d with INTERP_MEMORY. JAX's random rows and times are
taken from its own key and handed to the port (``infos['mem_index']``,
``infos['mem_time']``): torch cannot replay JAX's keys.

Tolerances (float32): the loss 1e-4 relative; the gradients 1e-2 of the
largest gradient; the bank's rows (unit vectors after the update) 1e-3 of
1, rows not written equal; the 3-step trajectory at lr 1e-4 within 5e-2 of
what each tensor moved in JAX plus 1e-6 of the tree's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advise_tpu import config as jconfig
from advise_tpu.engine import contrastive as jc
from advise_tpu.models import build_model as jbuild_model
from advise_tpu_torch import config as tconfig
from advise_tpu_torch.engine import contrastive as tc
from advise_tpu_torch.models import build_model
from advise_tpu_torch.models.layers.norm import commit_bn_stats
from advise_tpu_torch.utils.convert import batch_stats_to_torch, params_to_torch

from torch_port_common import (
    CON_B,
    contrastive_cfg,
    contrastive_clips,
    contrastive_setup,
    contrastive_step_pair,
    moved_within,
    port_contrastive,
)

torch.set_num_threads(1)

LR = float(np.float32(1e-4))
CASES = {"1d": {}, "2d": {"CONTRASTIVE.MEM_TYPE": "2d", "CONTRASTIVE.DURATION": 4},
         "interp": {"CONTRASTIVE.MEM_TYPE": "2d", "CONTRASTIVE.DURATION": 4, "CONTRASTIVE.INTERP_MEMORY": True}}
# the third item's time, 1.0, puts both interpolation slots on the last one (t0 == t1)
TIME_IDX = np.asarray([0.0, 0.5, 1.0, 0.25], np.float32)


def jax_draws(jcfg, key, duration):
    """The random rows [B, QUEUE_LEN + 1] and times mem_loss draws from
    ``key``: split into (rows, times), randint rows in [0, LENGTH), then
    with INTERP_MEMORY uniform times in [0, DURATION - 1), else with
    DURATION > 1 randint times in [0, DURATION)."""
    k, length = jcfg.CONTRASTIVE.QUEUE_LEN, jcfg.CONTRASTIVE.LENGTH
    r_ind, r_time = jax.random.split(key)
    out = {"mem_index": np.asarray(jax.random.randint(r_ind, (CON_B, k + 1), 0, length))}
    if jcfg.CONTRASTIVE.INTERP_MEMORY:
        out["mem_time"] = np.asarray(jax.random.uniform(r_time, (CON_B, k + 1), minval=0.0,
                                                        maxval=float(duration - 1)))
    elif duration > 1:
        out["mem_time"] = np.asarray(jax.random.randint(r_time, (CON_B, k + 1), 0, duration))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_ssl_state(case):
    """The bank [LENGTH, DURATION or 1, DIM] uniform on (-stdv, stdv), no
    momentum encoder; the same names, shapes and dtypes as JAX's."""
    jcfg, tcfg = contrastive_cfg(jconfig, "mem", **CASES[case]), contrastive_cfg(tconfig, "mem", **CASES[case])
    model = build_model(tcfg, "cpu")
    ssl = tc.init_ssl_state(tcfg, model, torch.Generator().manual_seed(0))
    jssl = jc.init_ssl_state(jcfg, {}, {}, jax.random.PRNGKey(0))
    assert set(ssl) == set(jssl) == {"memory", "knn_mem"}
    assert tuple(ssl["memory"].shape) == jssl["memory"].shape == (32, 1 if case == "1d" else 4, 16)
    stdv = 1.0 / np.sqrt(16 / 3)
    assert -stdv <= float(ssl["memory"].min()) and float(ssl["memory"].max()) <= stdv


def test_interp_weights_match_jax():
    """The adjacent slots and the reference's inverted weight, verbatim."""
    t = np.asarray([0.0, 0.2, 1.0, 1.5, 2.99, 3.0, 3.4], np.float32)
    want = jc._mem_interp_weights(jnp.asarray(t), 4)
    got = tc._mem_interp_weights(torch.from_numpy(t), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[2][1, 0]) == pytest.approx(1.0 - 0.2)  # 1 - (time - t0): the inverse of a lerp


@pytest.mark.parametrize("case", sorted(CASES))
def test_mem_loss_and_bank_match_jax(case):
    """The NCE over [own row, QUEUE_LEN random rows] with JAX's rows and
    times: the loss, the gradients, the running statistics, every row of
    the bank after the momentum update (with INTERP_MEMORY item 2's two
    writes on one slot: the second wins) and the kNN bank."""
    jcfg, tcfg, params, batch_stats, ssl = contrastive_setup("mem", **CASES[case])
    duration = ssl["memory"].shape[1]
    x = contrastive_clips(5)
    infos = {"item_id": np.asarray([3, 17, 8, 30], np.int32), "time_idx": TIME_IDX}
    jj = jcfg.clone()
    jj.TPU.PARTITION_MODE = "auto"
    jm = jbuild_model(jj, sync_axes=())

    def loss_fn(p, s):
        loss, bs, new_ssl, stats = jc.mem_loss(jj, jm, p, batch_stats, s, [jnp.asarray(x[:, 0]),
                                                                          jnp.asarray(x[:, 1])],
                                               infos, jax.random.PRNGKey(9))
        return loss, (bs, new_ssl)

    (loss_j, (bs_j, ssl_j)), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, ssl)
    ssl_j = jax.device_get(ssl_j)
    draws = jax_draws(jcfg, jax.random.PRNGKey(9), duration)
    model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
    tinfos = {k: torch.from_numpy(np.array(v)) for k, v in {**infos, **draws}.items()}
    loss_t, tssl, stats = tc.mem_loss(tcfg, model, tssl, torch.from_numpy(x).transpose(0, 1), tinfos, None)
    loss_t.backward()
    commit_bn_stats(model)
    assert set(stats) == {"loss_nce"}
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    grads = {n: p.grad for n, p in model.named_parameters()}
    g_ref = params_to_torch(jax.device_get(g_j))
    top = max(float(v.abs().max()) for v in g_ref.values())
    assert all(float((grads[k] - v).abs().max()) <= 1e-2 * top for k, v in g_ref.items())
    own = model.state_dict()
    for k, v in batch_stats_to_torch(jax.device_get(bs_j)).items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
    bank, want = tssl["memory"].numpy(), np.asarray(ssl_j["memory"])
    written = np.abs(want - np.asarray(ssl["memory"])).max(axis=-1) > 0  # [LENGTH, DURATION]
    # a slot per item; with INTERP_MEMORY two, but one for item 8 (t0 == t1)
    assert written.sum() == (2 * CON_B - 1 if case == "interp" else CON_B)
    assert np.abs(bank - want).max() <= 1e-3
    np.testing.assert_array_equal(bank[~written], want[~written])
    np.testing.assert_allclose(np.linalg.norm(bank[written], axis=-1), 1.0, atol=1e-5)
    if case == "interp":
        # item 8 at time 1.0: slot 3 twice; its value is the second write's
        assert written[8].tolist() == [False, False, False, True]
    assert float((tssl["knn_mem"] - torch.from_numpy(np.array(ssl_j["knn_mem"]))).abs().max()) <= 1e-3


def test_mem_draws_from_the_generator():
    """Without the caller's draws the rows and times come from the step's
    generator: the same seed gives the same loss and bank, another seed
    another loss."""
    _, tcfg, params, batch_stats, ssl = contrastive_setup("mem", **CASES["2d"])
    x = torch.from_numpy(contrastive_clips(6)).transpose(0, 1)
    infos = {"item_id": torch.arange(CON_B), "time_idx": torch.from_numpy(TIME_IDX)}
    out = []
    for seed in (0, 0, 1):
        model, tssl = port_contrastive(tcfg, params, batch_stats, ssl)
        loss, tssl, _ = tc.mem_loss(tcfg, model, tssl, x, infos, torch.Generator().manual_seed(seed))
        out.append((loss.item(), tssl["memory"].clone()))
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])
    assert out[0][0] != out[2][0]


def test_three_step_trajectory_matches_jax():
    """The contrastive step with mem (2d, INTERP_MEMORY) 3 times from the
    same state against JAX's jitted step, JAX's rows and times (from the
    step's key: fold_in(fold_in(key, replica 0), step), its second split,
    then mem_loss's split) handed to the port: the loss and grad norm of
    each step, what each parameter and BN statistic moved, the bank and
    the kNN bank."""
    jcfg, tcfg, params, batch_stats, ssl = contrastive_setup("mem", **CASES["interp"])
    jstep, jstate, tstep, tstate = contrastive_step_pair(jcfg, tcfg, params, batch_stats, ssl)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        ids = np.arange(CON_B, dtype=np.int32) * 7 + i
        times = np.roll(TIME_IDX, i)
        x = contrastive_clips(20 + i)
        key = jax.random.PRNGKey(i)
        drop = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, 0), i))[1]
        draws = jax_draws(jcfg, drop, 4)
        jstate, jstats = jstep(jstate, jnp.asarray(x), {"item_id": ids, "time_idx": times}, key,
                               jnp.float32(LR), jnp.float32(0.5))
        tinfos = {k: torch.from_numpy(np.array(v)) for k, v in
                  {"item_id": ids, "time_idx": times, **draws}.items()}
        tstats = tstep(tstate, torch.from_numpy(x), tinfos, gen, LR, 0.5)
        assert set(tstats) == {"loss_nce", "grad_norm"}
        assert abs(tstats["loss_nce"].item() - float(jstats["loss_nce"])) <= 1e-4 * abs(float(jstats["loss_nce"]))
        assert tstats["grad_norm"].item() == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
    jstate = jax.device_get(jstate)
    own = tstate.model.state_dict()
    assert not moved_within(own, params_to_torch(jstate.params), params_to_torch(params))
    assert not moved_within(own, batch_stats_to_torch(jstate.batch_stats), batch_stats_to_torch(batch_stats))
    for name in ("memory", "knn_mem"):
        assert float((tstate.ssl[name] - torch.from_numpy(np.array(jstate.ssl[name]))).abs().max()) <= 1e-3, name


def test_trainer_runs_mem_and_resumes_the_bank_bit_exactly(tmp_path):
    """The memory bank (2d, DURATION 4, INTERP_MEMORY) through the trainer:
    the loader's ``time_idx`` reaches the loss, the rows and times from
    each iteration's generator; the run cut after epoch 0 and resumed
    EQUALS the run never cut: stats, model, bank, bit for bit."""
    from torch_port_common import resume_matches_straight

    state, _, straight, _, saved = resume_matches_straight(tmp_path, "mem", ["memory", "knn_mem"], **CASES["interp"])
    assert set(state.ssl) == {"memory", "knn_mem", "knn_labels"} and tuple(state.ssl["memory"].shape) == (16, 4, 16)
    assert not torch.equal(saved["ssl"]["memory"], state.ssl["memory"])
    assert all(set(st) == {"loss_nce", "grad_norm"} for st in straight["stats"])
