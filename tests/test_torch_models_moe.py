"""The port's MoE block (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``): each dispatch (``grouped``, ``einsum``,
``scatter``) on the same block parameters and inputs, at prefill, decode
and multi-group token counts, with the routing (gates, experts, slot
positions, kept tokens) equal; top-k ties broken as ``jax.lax.top_k``
breaks them; a token count that does not split into whole groups refused
by both; and the three dispatches through a whole reduced MoE model.

Tolerance: float32, max |port - reference| <= 1e-4 x max |reference| (the
aux loss: 1e-4 relative); integer routing outputs exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import builder as RB
from repro.models import moe as RM
from repro_torch.configs import get_arch
from repro_torch.models import builder as PB
from repro_torch.models import moe as PM
from repro_torch.models.convert import params_from_reference

RTOL = 1e-4
DISPATCHES = ("grouped", "einsum", "scatter")
ARCH = "qwen3-moe-235b-a22b"
#: (batch, positions, group tokens): a prefill, a decode step of 2
#: requests, 4 groups of 16 and 3 of 24 (grouped's per-group capacity)
SHAPES = ((2, 32, 512), (2, 1, 512), (4, 16, 16), (3, 24, 24))


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _block(seed=0):
    """One MoE block's reference parameters (numpy) and the config."""
    cfg = ref_get_arch(ARCH).reduced()
    p = RB._init_block("moe", cfg, jax.random.PRNGKey(seed), jnp.float32)
    return cfg, {k: np.array(v) for k, v in p.items()}


def _both(x, p, cfg, dispatch, group_tokens):
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor, dispatch=dispatch,
              group_tokens=group_tokens)
    ry, raux = RM.moe_block(jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in p.items()}, **kw)
    py, paux = PM.moe_block(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            **kw)
    return (py.numpy(), float(paux)), (np.asarray(ry), float(raux))


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("b,s,group", SHAPES)
def test_moe_block_matches_the_reference(dispatch, b, s, group):
    cfg, p = _block()
    x = np.random.default_rng(b * 100 + s).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    (py, paux), (ry, raux) = _both(x, p, cfg, dispatch, group)
    close(py, ry)
    assert abs(paux - raux) <= RTOL * abs(raux)


@pytest.mark.parametrize("capacity", (4, 9))
def test_routing_matches_the_reference(capacity):
    """Gates, experts, slot positions and kept tokens of ``_routing``,
    with capacities that drop tokens (4) and keep most (9)."""
    cfg, p = _block(1)
    ht = np.random.default_rng(capacity).normal(
        size=(64, cfg.d_model)).astype(np.float32)
    want = RM._routing(jnp.asarray(ht), jnp.asarray(p["router"]),
                       cfg.n_experts, cfg.top_k, capacity)
    got = PM._routing(torch.from_numpy(ht), torch.from_numpy(p["router"]),
                      cfg.n_experts, cfg.top_k, capacity)
    names = ("gate_vals", "gate_idx", "pos", "keep", "probs", "onehot")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype.kind == "f":
            close(g, w)
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), name
    assert not np.asarray(want[3]).all()        # capacity 4 drops some


def test_top_k_breaks_ties_as_jax_does():
    """Equal router probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` leaves it open)."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = PM._top_k(torch.from_numpy(probs), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi)), k
        assert np.array_equal(gv.numpy(), np.asarray(wv)), k
    # a zero router: every token ties on every expert
    cfg, p = _block()
    p = dict(p, router=np.zeros_like(p["router"]))
    x = np.random.default_rng(3).normal(size=(2, 8, cfg.d_model)).astype(
        np.float32)
    for dispatch in DISPATCHES:
        (py, _), (ry, _) = _both(x, p, cfg, dispatch, 512)
        close(py, ry)


def test_grouped_dispatch_refuses_ragged_groups():
    """33 tokens in groups of 16 make 2 groups of 16, one token over: the
    reference's reshape fails, and the port raises."""
    cfg, p = _block()
    x = np.zeros((1, 33, cfg.d_model), np.float32)
    with pytest.raises(TypeError):
        RM.moe_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                      p.items()},
                     n_experts=cfg.n_experts, top_k=cfg.top_k,
                     dispatch="grouped", group_tokens=16)
    with pytest.raises(ValueError, match="groups"):
        PM.moe_block(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v
                                           in p.items()},
                     n_experts=cfg.n_experts, top_k=cfg.top_k,
                     dispatch="grouped", group_tokens=16)


def test_unknown_dispatch_raises():
    cfg, p = _block()
    with pytest.raises(ValueError, match="unknown moe dispatch"):
        PM.moe_block(torch.zeros(1, 2, cfg.d_model),
                     {k: torch.from_numpy(v) for k, v in p.items()},
                     n_experts=cfg.n_experts, top_k=cfg.top_k,
                     dispatch="dense")


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_model_matches_the_reference(dispatch):
    """A whole reduced MoE model under each dispatch (groups of 16 tokens
    for ``grouped``): prefill logits and ``train_loss``."""
    cfg = dataclasses.replace(ref_get_arch(ARCH).reduced(),
                              moe_dispatch=dispatch, moe_group_tokens=16)
    pcfg = dataclasses.replace(get_arch(ARCH).reduced(),
                               moe_dispatch=dispatch, moe_group_tokens=16)
    rmodel, pmodel = RB.build_model(cfg), PB.build_model(pcfg)
    rparams = jax.jit(RB.init_params, static_argnums=0)(
        rmodel, jax.random.PRNGKey(2))
    pparams = params_from_reference(pmodel,
                                    jax.tree.map(np.asarray, rparams))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 32))
    rb = {"tokens": jnp.asarray(toks, jnp.int32)}
    pb = {"tokens": torch.from_numpy(toks)}
    rl, _ = jax.jit(lambda p, b: RB.prefill(rmodel, p, b))(rparams, rb)
    pl, _ = PB.prefill(pmodel, pparams, pb)
    close(pl.numpy(), np.asarray(rl))
    rloss, _ = jax.jit(lambda p, b: RB.train_loss(rmodel, p, b))(rparams, rb)
    with torch.no_grad():
        ploss, _ = PB.train_loss(pmodel, pparams, pb)
    assert abs(float(ploss) - float(rloss)) <= RTOL * abs(float(rloss))
