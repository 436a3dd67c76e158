"""The port's LM zoo (``repro_torch.models``) against the reference
(``repro.models``): for every arch at ``reduced()`` width, the reference's
``init_params`` carried over by ``repro_torch.models.convert``, the same
numpy inputs, and the port's ``prefill`` logits, one ``decode`` step's
logits and ``train_loss`` held against the reference's.  Then the
reference's own zoo tests, ported: prefill-decode parity, the MoE routing
mass and the reduced configs' sizes, on the port alone.

Tolerance: float32 on both sides, max |port - reference| <= 1e-4 x max
|reference| over each logits array (the loss: 1e-4 relative).  The two
sum in other orders (the port's sequential RG-LRU scan against an
associative one, attention through K4's plain version), so equality is to
float32 rounding, not bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs as ref_list_archs
from repro.models import builder as RB
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import builder as PB
from repro_torch.models.convert import params_from_reference

B, S = 2, 32
RTOL = 1e-4
#: the reference's prefill-decode parity archs (MoE excluded: capacity-
#: limited routing is sequence-global) and its tolerance
PARITY_ARCHS = ("llama3-8b", "mamba2-780m", "recurrentgemma-9b",
                "internvl2-1b", "seamless-m4t-medium")
PARITY_TOL = 2e-2


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _inputs(cfg, rng):
    """numpy inputs of one batch, as the reference's zoo tests draw them."""
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(B, S // 8, cfg.d_model)).astype(np.float32)
    return out


def _port_batch(inputs):
    return {k: (torch.from_numpy(v).long() if k == "tokens"
                else torch.from_numpy(v)) for k, v in inputs.items()}


@functools.lru_cache(maxsize=None)
def _run(name):
    """Both packages on one arch: {what: (port, reference)}."""
    cfg = ref_get_arch(name).reduced()
    rmodel = RB.build_model(cfg)
    rparams = jax.jit(RB.init_params, static_argnums=0)(
        rmodel, jax.random.PRNGKey(0))
    pmodel = PB.build_model(get_arch(name).reduced())
    pparams = params_from_reference(pmodel, jax.tree.map(np.asarray,
                                                          rparams))
    rng = np.random.default_rng(0)
    inputs = _inputs(cfg, rng)
    next_tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    prefix = cfg.frontend_seq if cfg.family == "vlm" else 0
    max_len = prefix + S + 4

    rb = {k: jnp.asarray(v) for k, v in inputs.items()}
    # jitted as a whole (one compile each; op by op is several times slower)
    rl, rs = jax.jit(lambda p, b: RB.prefill(rmodel, p, b, max_len=max_len))(
        rparams, rb)
    rd, _ = jax.jit(lambda p, s, t, i: RB.decode(rmodel, p, s, t, i))(
        rparams, rs, jnp.asarray(next_tok), jnp.asarray(prefix + S,
                                                        jnp.int32))
    rloss, rm = jax.jit(lambda p, b: RB.train_loss(rmodel, p, b))(rparams, rb)

    pb = _port_batch(inputs)
    pl, ps = PB.prefill(pmodel, pparams, pb, max_len=max_len)
    pd, _ = PB.decode(pmodel, pparams, ps, torch.from_numpy(next_tok).long(),
                      prefix + S)
    with torch.no_grad():
        ploss, pm = PB.train_loss(pmodel, pparams, pb)
    return {"prefill": (pl.numpy(), np.asarray(rl)),
            "decode": (pd.numpy(), np.asarray(rd)),
            "loss": (float(ploss), float(rloss)),
            "nll": (float(pm["nll"]), float(rm["nll"])),
            "aux": (float(pm["aux"]), float(rm["aux"]))}


def test_port_configs_are_the_references():
    assert list_archs() == ref_list_archs()
    for name in list_archs():
        assert (dataclasses.asdict(get_arch(name))
                == dataclasses.asdict(ref_get_arch(name))), name
        assert (dataclasses.asdict(get_arch(name).reduced())
                == dataclasses.asdict(ref_get_arch(name).reduced())), name


@pytest.mark.parametrize("name", list_archs())
def test_prefill_logits_match_the_reference(name):
    got, want = _run(name)["prefill"]
    assert got.shape == (B, 1, get_arch(name).reduced().vocab)
    close(got, want)


@pytest.mark.parametrize("name", list_archs())
def test_decode_logits_match_the_reference(name):
    got, want = _run(name)["decode"]
    close(got, want)


@pytest.mark.parametrize("name", list_archs())
def test_train_loss_matches_the_reference(name):
    out = _run(name)
    for what in ("loss", "nll"):
        got, want = out[what]
        assert abs(got - want) <= RTOL * abs(want), (what, got, want)
    got, want = out["aux"]
    assert abs(got - want) <= RTOL * max(abs(want), 1.0), ("aux", got, want)


def _port_model(name, seed):
    cfg = get_arch(name).reduced()
    model = PB.build_model(cfg)
    params = PB.init_params(model, torch.Generator().manual_seed(seed))
    return cfg, model, params


@pytest.mark.parametrize("name", list_archs())
def test_train_loss_backward_gives_finite_gradients(name):
    """The reference's ``test_arch_smoke``: a finite loss, a gradient on
    every trainable parameter (attention included: training never goes
    through K4, which has no backward), finite and not all zero."""
    cfg, model, params = _port_model(name, 0)
    batch = _port_batch(_inputs(cfg, np.random.default_rng(0)))
    loss, _ = PB.train_loss(model, params, batch)
    assert loss.shape == () and torch.isfinite(loss)
    loss.backward()
    missing = [n for n, p in params.named_parameters()
               if p.requires_grad and p.grad is None]
    assert not missing, (name, missing)
    gn = sum(float(p.grad.square().sum()) for p in params.parameters()
             if p.requires_grad)
    assert np.isfinite(gn) and gn > 0, name


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_prefill_decode_parity(name):
    """Decoding token S with the prefill cache matches prefilling S+1
    tokens (the reference's ``test_prefill_decode_parity`` on the port)."""
    rng = np.random.default_rng(1)
    cfg, model, params = _port_model(name, 1)
    inputs = _inputs(cfg, rng)
    batch = _port_batch(inputs)
    prefix = cfg.frontend_seq if cfg.family == "vlm" else 0
    logits1, states = PB.prefill(model, params, batch, max_len=prefix + S + 4)
    next_tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).long()
    logits_dec, _ = PB.decode(model, params, states, next_tok, prefix + S)

    batch2 = dict(batch)
    batch2["tokens"] = torch.cat([batch["tokens"], next_tok], dim=1)
    logits2, _ = PB.prefill(model, params, batch2)
    np.testing.assert_allclose(logits_dec[:, 0].numpy(),
                               logits2[:, -1].numpy(), atol=PARITY_TOL,
                               rtol=PARITY_TOL)


@pytest.mark.parametrize("name", list_archs())
def test_init_decode_state_is_laid_out_as_prefill_returns_it(name):
    """``init_decode_state`` gives the segments, layers, block keys,
    shapes and types of ``prefill``'s states, all zero."""
    cfg, model, params = _port_model(name, 0)
    inputs = _inputs(cfg, np.random.default_rng(0))
    prefix = cfg.frontend_seq if cfg.family == "vlm" else 0
    _, states = PB.prefill(model, params, _port_batch(inputs),
                           max_len=prefix + S + 4)
    enc_len = S // 8 if cfg.family == "audio" else 0
    zeros = PB.init_decode_state(model, B, prefix + S + 4, enc_len=enc_len)
    flat = jax.tree.leaves(states)
    zflat = jax.tree.leaves(zeros)
    assert jax.tree.structure(states) == jax.tree.structure(zeros)
    assert [(t.shape, t.dtype) for t in flat] == [
        (t.shape, t.dtype) for t in zflat]
    assert all(not t.any() for t in zflat)


def test_moe_routing_mass():
    """MoE combine weights renormalize: the aux loss is near 1 (balanced)
    for random tokens."""
    cfg, model, params = _port_model("qwen3-moe-235b-a22b", 0)
    batch = _port_batch(_inputs(cfg, np.random.default_rng(0)))
    with torch.no_grad():
        _, metrics = PB.train_loss(model, params, batch)
    assert 0.5 < float(metrics["aux"]) / cfg.n_layers < 4.0


def test_reduced_configs_are_small():
    for name in list_archs():
        cfg = get_arch(name).reduced()
        assert cfg.d_model <= 64
        assert cfg.n_layers <= 2
        assert cfg.vocab <= 512
