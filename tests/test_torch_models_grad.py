"""The LM zoo's gradients: the port's ``train_loss(...).backward()`` against
the reference's ``jax.grad`` of ``repro.models.train_loss``, on the same
parameters (the reference's ``init_params`` carried over by
``repro_torch.models.convert``) and the same numpy batch, at reduced width,
for a dense decoder (llama3-8b), an encoder-decoder with ``eattn`` and
``xattn`` blocks (seamless-m4t-medium) and an MoE (qwen3-moe-235b-a22b).
Every parameter must get a gradient, and attention must train through the
differentiable path, never through K4 (which has no backward).

Tolerance: float32 on both sides, max |port - reference| <= 1e-3 x max
|reference| over each parameter's gradient.  The backward passes sum over
the batch's 64 tokens and the layers' products in other orders than XLA.
Float32 rounding alone moves seamless-m4t-medium's gradients by up to
1.7e-4 of their largest entry (the port in float32 against the port in
float64), so two float32 runs may differ by twice that; the largest
difference measured against the reference is 7.1e-5 (seamless's tied
embedding).  A gradient that misses a path is off by order 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import builder as RB
from repro_torch.configs import get_arch
from repro_torch.models import builder as PB
from repro_torch.models import layers as PL
from repro_torch.models.convert import params_from_reference

B, S = 2, 32
GRAD_RTOL = 1e-3
ARCHS = ("llama3-8b", "seamless-m4t-medium", "qwen3-moe-235b-a22b")


def _inputs(cfg, rng):
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(B, S // 8, cfg.d_model)).astype(np.float32)
    return out


def _port_batch(inputs):
    return {k: (torch.from_numpy(v).long() if k == "tokens"
                else torch.from_numpy(v)) for k, v in inputs.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_gradients_match_the_reference(name):
    cfg = ref_get_arch(name).reduced()
    rmodel = RB.build_model(cfg)
    rparams = jax.jit(RB.init_params, static_argnums=0)(
        rmodel, jax.random.PRNGKey(0))
    pmodel = PB.build_model(get_arch(name).reduced())
    pparams = params_from_reference(pmodel, jax.tree.map(np.asarray,
                                                          rparams))
    inputs = _inputs(cfg, np.random.default_rng(0))
    rgrads = jax.jit(jax.grad(lambda p, b: RB.train_loss(rmodel, p, b)[0]))(
        rparams, {k: jnp.asarray(v) for k, v in inputs.items()})
    # the reference's gradient tree laid out as the port's parameters
    want = dict(params_from_reference(
        pmodel, jax.tree.map(np.asarray, rgrads)).named_parameters())

    loss, _ = PB.train_loss(pmodel, pparams, _port_batch(inputs))
    loss.backward()
    got = dict(pparams.named_parameters())
    assert sorted(got) == sorted(want)
    missing = [n for n, p in got.items() if p.grad is None]
    assert not missing, missing
    for n, p in got.items():
        w = want[n].detach()
        scale = float(w.abs().max())
        assert scale > 0, n
        err = float((p.grad - w).abs().max())
        assert err <= GRAD_RTOL * scale, (n, err, scale)


@pytest.mark.parametrize("name", ARCHS)
def test_training_attends_off_k4_and_inference_on_it(monkeypatch, name):
    """With autograd on, ``train_loss`` never calls K4's wrapper (its blocks
    take ``attend_plain``); under ``torch.no_grad`` the same forward calls
    it once per attn/eattn/xattn block and gives the same loss."""
    calls = []
    real = PL.flash_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(PL, "flash_attention", counted)
    cfg = get_arch(name).reduced()
    model = PB.build_model(cfg)
    params = PB.init_params(model, torch.Generator().manual_seed(0))
    batch = _port_batch(_inputs(cfg, np.random.default_rng(1)))
    train, _ = PB.train_loss(model, params, batch)
    assert train.requires_grad and not calls
    with torch.no_grad():
        infer, _ = PB.train_loss(model, params, batch)
    blocks = sum(seg.count * sum(k in ("attn", "eattn", "xattn")
                                 for k in seg.pattern)
                 for seg in PB.all_segments(model))
    assert len(calls) == blocks > 0
    train = float(train.detach())
    assert abs(train - float(infer)) <= 1e-5 * abs(train)
