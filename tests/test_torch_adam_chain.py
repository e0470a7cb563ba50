"""``solver/optimizer.py Adam`` runs each step of its chain over all leaves
at once (``torch._foreach_*``); the results are bit for bit those of the
chain written leaf by leaf (below, as the class computed it before), for
adamw and adam, with and without the clip and LARS."""

import numpy as np
import pytest
import torch

from advise_tpu_torch.solver.optimizer import Adam, global_grad_norm, trust_ratio


def leaf_by_leaf(tx, grads, state, params):
    g = dict(grads)
    if tx.clip_norm > 0:
        norm = global_grad_norm(g)
        keep = norm < tx.clip_norm
        g = {n: torch.where(keep, v, v / norm.to(v.dtype) * tx.clip_norm) for n, v in g.items()}
    if not tx.decoupled:
        g = {n: v + tx.wds[n] * params[n] for n, v in g.items()}
        if tx.lars:
            g = trust_ratio(g, params)
    count = state["count"] + 1
    b1, b2 = tx.b1, tx.b2
    mu = {n: (1 - b1) * v + b1 * state["mu"][n] for n, v in g.items()}
    nu = {n: (1 - b2) * (v * v) + b2 * state["nu"][n] for n, v in g.items()}
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    d = {n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + tx.eps) for n in g}
    if tx.decoupled:
        if tx.lars:
            d = trust_ratio(d, params)
        d = {n: v + tx.wds[n] * params[n] for n, v in d.items()}
    return d, {"mu": mu, "nu": nu, "count": count}


@pytest.mark.parametrize("lars", [False, True])
@pytest.mark.parametrize("clip", [0.0, 0.02, 1e3])
@pytest.mark.parametrize("decoupled", [True, False])
def test_chain_equals_the_leaf_by_leaf_chain(decoupled, clip, lars):
    g = torch.Generator().manual_seed(3)
    shapes = {"a.weight": (6, 5), "a.bias": (6,), "b.weight": (2, 3, 4), "c": (1,)}
    params = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    wds = {n: 0.05 if p.ndim > 1 else 0.0 for n, p in params.items()}
    tx = Adam(wds, 0.9, 0.999, 1e-8, clip, decoupled=decoupled, lars=lars)
    state = {"mu": {n: torch.randn(p.shape, generator=g) * 1e-3 for n, p in params.items()},
             "nu": {n: torch.rand(p.shape, generator=g) * 1e-6 for n, p in params.items()}, "count": 4}
    for _ in range(2):
        grads = {n: torch.randn(p.shape, generator=g) for n, p in params.items()}
        got, got_state = tx.update(grads, state, params)
        want, want_state = leaf_by_leaf(tx, grads, state, params)
        assert got_state["count"] == want_state["count"]
        for n in params:
            assert torch.equal(got[n], want[n]), n
            assert torch.equal(got_state["mu"][n], want_state["mu"][n]) and torch.equal(got_state["nu"][n],
                                                                                      want_state["nu"][n]), n
        state = got_state
