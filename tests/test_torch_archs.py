"""The port's other predictor archs (fc, mlp, cnn, lstm) and LSH attention
against the JAX reference: the same parameters and inputs give the same
logits and gradients; ``lsh_attention`` and ``hlsh_erased_fraction`` alone
match; every arch's state dict loads the reference's pytree strictly; and
the footprint accounting of Tables 6-7 (``count_activation_elems``,
``param_bytes``, ``footprint_report``) gives the reference's integers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import attention as j_attn
from repro.core import model as j_model
from repro.core import quantize as j_quant
from repro.core import train as j_train
from repro_torch.core import attention as t_attn
from repro_torch.core import families as t_families
from repro_torch.core import model as t_model
from repro_torch.core import quantize as t_quant
from repro_torch.core.convert import params_from_jax
from repro_torch.core.model import Predictor
from repro_torch.core.train import loss_fn
from repro_torch.core.vocab import FEATURE_BUCKETS

N_CLASSES = 64
#: the comparison archs at the reference's widths (13 features, d_model 200,
#: hidden 128), fc also quantized, and a 2-layer, 2-head Transformer with
#: LSH attention on the 12-dim feature set
CONFIGS = {
    "fc": t_families.PredictorConfig(n_classes=N_CLASSES, arch="fc"),
    "fc-quantized": t_families.PredictorConfig(n_classes=N_CLASSES,
                                               arch="fc", quantize=True),
    "mlp": t_families.PredictorConfig(n_classes=N_CLASSES, arch="mlp"),
    "cnn": t_families.PredictorConfig(n_classes=N_CLASSES, arch="cnn"),
    "lstm": t_families.PredictorConfig(n_classes=N_CLASSES, arch="lstm"),
    "transformer-lsh": t_families.PredictorConfig(
        n_classes=N_CLASSES, attention="lsh",
        features=t_families.REVISED_FEATURES, revised_dims=True,
        n_layers=2, n_heads=2),
}
#: fc's and mlp's first product sums seq_len x d_model = 6,000 terms per
#: entry (and their gradients as many), in another order than XLA's:
#: float32 rounding of such sums reaches a few 1e-5, the bound the
#: Transformer's 3,840-term gradients already use; every other product
#: here is held to 1e-5
ATOL = {"fc": 5e-5, "fc-quantized": 5e-5, "mlp": 5e-5}


def _inputs(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, FEATURE_BUCKETS[f], (rows, cfg.seq_len))
            for f in cfg.features]
    return np.stack(cols, -1).astype(np.int32)


def _jax_lsh_projection(cfg):
    """The reference's LSH projection: ``jax.random.normal`` under
    ``PRNGKey(lsh_seed)``, unsplit, as its ``lsh_hash`` draws it."""
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(cfg.lsh_seed),
        (cfg.d_model // cfg.n_heads, cfg.n_hashes, cfg.n_buckets // 2),
        jnp.float32)))


def _pair(cfg, key=1):
    """JAX params and the port's Predictor holding the same values (LSH
    with the reference's projection)."""
    params = jax.jit(lambda k: j_model.init_params(cfg, k))(
        jax.random.PRNGKey(key))
    model = Predictor(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                          strict=True)
    if cfg.attention == "lsh":
        model.set_lsh_projection(_jax_lsh_projection(cfg))
    return params, model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_is_the_reference_pytree(name):
    """Every leaf of the reference's pytree has a parameter of the same
    name and shape, and nothing else: the strict load succeeds."""
    cfg = CONFIGS[name]
    params = jax.tree.map(np.asarray, j_model.init_params(
        cfg, jax.random.PRNGKey(0)))
    state = params_from_jax(params)
    model = Predictor(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {n: tuple(p.shape) for n, p in model.state_dict().items()} == {
        n: tuple(t.shape) for n, t in state.items()}
    model.load_state_dict(state, strict=True)
    assert len(state) == len(jax.tree.leaves(params))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_reference(name):
    cfg = CONFIGS[name]
    params, model = _pair(cfg)
    x = _inputs(cfg, 256, seed=3)
    want = np.asarray(jax.jit(lambda p, xb: j_model.apply(cfg, p, xb))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (256, N_CLASSES)
    np.testing.assert_allclose(got, want, atol=ATOL.get(name, 1e-5))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gradients_match_reference(name):
    cfg = CONFIGS[name]
    params, model = _pair(cfg, key=2)
    x = _inputs(cfg, 128, seed=4)
    y = np.random.default_rng(5).integers(0, N_CLASSES, 128).astype(np.int32)
    jgrads = jax.jit(jax.grad(lambda p, xb, yb: j_train._loss_fn(
        cfg, p, xb, yb)))(params, jnp.asarray(x), jnp.asarray(y))
    want = {k: v.numpy() for k, v in
            params_from_jax(jax.tree.map(np.asarray, jgrads)).items()}
    loss = loss_fn(model, torch.as_tensor(x), torch.as_tensor(y))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        g = np.zeros_like(want[n]) if g is None else g.numpy()
        np.testing.assert_allclose(g, want[n], atol=ATOL.get(name, 1e-5),
                                   err_msg=n)


def test_fc_quantized_head_goes_through_the_int4_wrapper(monkeypatch):
    """At inference the quantized fc head is one K3 product (its plain
    version on these CPU tensors); the other archs' products are plain."""
    from repro_torch.kernels import ops as t_ops
    calls = []

    def counted(*a, _fn=t_ops.int4_matmul, **k):
        calls.append(a[0].shape)
        return _fn(*a, **k)
    monkeypatch.setattr(t_ops, "int4_matmul", counted)
    for name in ("fc-quantized", "mlp", "cnn", "lstm"):
        cfg = CONFIGS[name]
        model = Predictor(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
        with torch.no_grad():
            model(torch.as_tensor(_inputs(cfg, 16, seed=7)))
    assert calls == [(16, 30 * 200)]


def test_lsh_attention_matches_reference():
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(16, 30, 12)).astype(np.float32)
               for _ in range(3))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda a, b, c: j_attn.lsh_attention(
        a, b, c, key, 4, 8))(q, k, v))
    r = torch.tensor(np.asarray(jax.random.normal(key, (12, 4, 4),
                                                  jnp.float32)))
    got = t_attn.lsh_attention(*(torch.as_tensor(a) for a in (q, k, v)), r)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the mask bites: some pairs do not collide in any of the 4 rounds
    qn = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-6)
    buckets = t_attn.lsh_hash(torch.as_tensor(qn), r)
    same = (buckets[:, :, None] == buckets[:, None]).any(-1)
    assert not bool(same.all())


def test_lsh_projection_comes_from_torch_generator():
    r1 = t_attn.lsh_projection(12, 8, 8, 7)
    r2 = t_attn.lsh_projection(12, 8, 8, 7)
    assert r1.shape == (12, 8, 4) and r1.dtype == torch.float32
    assert torch.equal(r1, r2)


def test_hlsh_erased_fraction_matches_reference():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(64, 30, 12)).astype(np.float32)
    q[:32] = q[:32, :1] * (1.0 + 0.01 * rng.random((32, 30, 1)))
    q[:32, 5] = rng.normal(size=(32, 12))
    plan = j_attn.hlsh_plan(jnp.asarray(q), jax.random.PRNGKey(7))
    want = float(j_attn.hlsh_erased_fraction(plan))
    r, sel = t_attn.lsh_draws(12, 8, 8, 30, 7)
    got = t_attn.hlsh_erased_fraction(
        t_attn.hlsh_plan(torch.as_tensor(q), r, sel))
    assert 0.0 < want < 1.0
    assert float(got) == pytest.approx(want, abs=1e-7)


def _footprint_configs():
    """Every arch, and Tables 6-7's full and revised (HLSH and bypass)
    configurations at class counts of the benchmarks' vocabularies."""
    out = {name: cfg for name, cfg in CONFIGS.items()}
    for n in (5, 145):
        out[f"table67-full-{n}"] = t_families.PredictorConfig(n_classes=n)
        for conv in (0.2, 0.99):
            out[f"table67-revised-{n}-{conv}"] = t_families.revised_config(
                n, conv)
    return out


FOOTPRINT_CONFIGS = _footprint_configs()


@pytest.mark.parametrize("name", sorted(FOOTPRINT_CONFIGS))
def test_footprint_matches_reference(name):
    cfg = FOOTPRINT_CONFIGS[name]
    params = j_model.init_params(cfg, jax.random.PRNGKey(0))
    model = Predictor(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (t_model.count_activation_elems(cfg)
            == j_model.count_activation_elems(cfg))
    for bits in (32, 4):
        assert (t_quant.param_bytes(model, bits)
                == j_quant.param_bytes(params, bits))
        assert t_quant.footprint_report(
            model, t_model.count_activation_elems(cfg), 128, bits) == \
            j_quant.footprint_report(
                params, j_model.count_activation_elems(cfg), 128, bits)


def test_every_arch_and_attention_builds_and_runs():
    """The port refuses no arch and no attention of the reference: each
    builds and gives finite logits of the right shape; an unknown arch
    raises."""
    for arch in t_model.ARCHS:
        for attn in t_model.ATTENTIONS:
            cfg = dataclasses.replace(CONFIGS["transformer-lsh"], arch=arch,
                                      attention=attn)
            model = Predictor(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
            with torch.no_grad():
                out = model(torch.as_tensor(_inputs(cfg, 4, seed=1)))
            assert out.shape == (4, N_CLASSES)
            assert bool(torch.isfinite(out).all())
    with pytest.raises(ValueError):
        Predictor(dataclasses.replace(CONFIGS["fc"], arch="gru"),
                  torch.Generator().manual_seed(0), device="cpu")
