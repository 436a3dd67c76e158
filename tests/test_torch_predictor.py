"""The port's predictor against the JAX reference: the same parameters and
inputs give the same logits and gradients; the HLSH draws, the HLSH plan,
K2's plain version, the optimizer and the schedule match."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import attention as j_attn
from repro.core import model as j_model
from repro.core import quantize as j_quant
from repro.core import train as j_train
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.optimizer import AdamW as JAdamW
from repro.optimizer import linear_warmup_cosine as j_sched
from repro_torch.core import attention as t_attn
from repro_torch.core import families as t_families
from repro_torch.core import quantize as t_quant
from repro_torch.core.convert import params_from_jax
from repro_torch.core.model import Predictor
from repro_torch.core.train import loss_fn
from repro_torch.core.vocab import FEATURE_BUCKETS
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.optimizer import AdamW as TAdamW
from repro_torch.optimizer import linear_warmup_cosine as t_sched

N_CLASSES = 64
#: configurations of this slice: the simplified predictor with HLSH or the
#: bypass (convergence below/above the 0.7 threshold), and the reference
#: Transformer family (13 features, 2 layers, 4-head full attention)
CONFIGS = {
    "hlsh": lambda q: t_families.revised_config(N_CLASSES, 0.2, quantize=q),
    "bypass": lambda q: t_families.revised_config(N_CLASSES, 0.9, quantize=q),
    "transformer": lambda q: t_families.family_config(
        "transformer", N_CLASSES),
}


def _inputs(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, FEATURE_BUCKETS[f], (rows, cfg.seq_len))
            for f in cfg.features]
    return np.stack(cols, -1).astype(np.int32)


def _pair(cfg, key=1):
    """JAX params and the port's Predictor holding the same values."""
    params = jax.jit(lambda k: j_model.init_params(cfg, k))(
        jax.random.PRNGKey(key))
    model = Predictor(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, model


@pytest.mark.parametrize("name,quantize", [
    ("hlsh", False), ("hlsh", True), ("bypass", False), ("bypass", True),
    ("transformer", False)])   # the reference Transformer is fp32 only
def test_logits_match_reference(name, quantize):
    cfg = CONFIGS[name](quantize)
    params, model = _pair(cfg)
    x = _inputs(cfg, 512, seed=3)
    want = np.asarray(jax.jit(lambda p, xb: j_model.apply(cfg, p, xb))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (512, N_CLASSES)
    if quantize:
        # fake-quant rounding can flip at a .5 boundary under a last-ulp
        # difference, so the quantized bar is top-1 agreement
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gradients_match_reference(name):
    cfg = CONFIGS[name](False)
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
    # the Transformer's 200 x 800 feed-forward gradients sum 3840 products
    # per entry, in another order than XLA's: float32 rounding of such sums
    # reaches a few 1e-5; the slice's 12-dim predictor is held to 1e-5
    atol = 5e-5 if name == "transformer" else 1e-5
    for n, g in zip(names, grads):
        g = np.zeros_like(want[n]) if g is None else g.numpy()
        np.testing.assert_allclose(g, want[n], atol=atol, err_msg=n)


def test_hlsh_draws_file_is_jax_draws():
    """The shipped constants are jax.random's draws under PRNGKey(7), split
    and drawn as the reference's hlsh_plan/lsh_hash draw them."""
    with open(t_attn.DRAWS_FILE) as f:
        doc = json.load(f)
    k_hash, k_sel = jax.random.split(jax.random.PRNGKey(doc["lsh_seed"]))
    r = jax.random.normal(k_hash, (doc["d"], doc["n_hashes"],
                                   doc["n_buckets"] // 2), jnp.float32)
    sel = jax.random.choice(k_sel, doc["n"], (max(doc["n"] // 2, 1),),
                            replace=False)
    np.testing.assert_array_equal(np.asarray(doc["r"], np.float32),
                                  np.asarray(r))
    np.testing.assert_array_equal(np.asarray(doc["sel"]), np.asarray(sel))
    cfg = t_families.revised_config(N_CLASSES, 0.2)
    assert (doc["d"], doc["n_hashes"], doc["n_buckets"], doc["n"],
            doc["lsh_seed"]) == (cfg.d_model, cfg.n_hashes, cfg.n_buckets,
                                 cfg.seq_len, cfg.lsh_seed)


def test_hlsh_plan_matches_reference():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(64, 30, 12)).astype(np.float32)
    # sequences of near-duplicate tokens exercise the share map, and an
    # unrelated token among them the erase
    q[:32] = q[:32, :1] * (1.0 + 0.01 * rng.random((32, 30, 1)))
    q[:32, 5] = rng.normal(size=(32, 12))
    want = jax.jit(lambda a: j_attn.hlsh_plan(a, jax.random.PRNGKey(7)))(
        jnp.asarray(q))
    r, sel = t_attn.lsh_draws(12, 8, 8, 30, 7)
    got = t_attn.hlsh_plan(torch.as_tensor(q), r, sel)
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    np.testing.assert_array_equal(got.share_src.numpy(),
                                  np.asarray(want.share_src))
    np.testing.assert_allclose(got.hscore.numpy(), np.asarray(want.hscore),
                               atol=1e-5)
    assert not got.keep.all() and (got.share_src != torch.arange(30)).any()


def test_lsh_draws_other_configs_come_from_torch_generator():
    r1, s1 = t_attn.lsh_draws(16, 4, 8, 20, 3)
    r2, s2 = t_attn.lsh_draws(16, 4, 8, 20, 3)
    assert r1.shape == (16, 4, 4) and s1.shape == (10,)
    assert torch.equal(r1, r2) and torch.equal(s1, s2)
    assert len(set(s1.tolist())) == 10


@pytest.mark.parametrize("b,n,d", [(1, 128, 32), (2, 256, 64), (1, 512, 128),
                                   (8, 30, 12)])
def test_hlsh_kernel_plain_version_matches_reference(b, n, d):
    rng = np.random.default_rng(b * n + d)
    q = rng.normal(size=(b, n, d)).astype(np.float32)
    v = rng.normal(size=(b, n, d)).astype(np.float32)
    keep = (rng.random((b, n)) > 0.3).astype(np.float32)
    keep[:, :min(128, n) // 2] = 0.0            # a fully erased key tile
    src = rng.integers(0, n, (b, n)).astype(np.int32)
    got = t_ops.hlsh_attention(*(torch.as_tensor(a) for a in (q, q, v, keep)),
                               torch.as_tensor(src)).numpy()
    oracle = t_ref.hlsh_attention_ref(
        *(torch.as_tensor(a) for a in (q, q, v, keep)),
        torch.as_tensor(src)).numpy()
    args = [jnp.asarray(a) for a in (q, q, v, keep, src)]
    pallas = np.asarray(j_ops.hlsh_attention(*args, interpret=True))
    want = np.asarray(j_ref.hlsh_attention_ref(*args))
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, pallas, atol=2e-4)
    np.testing.assert_allclose(oracle, want, atol=2e-4)


@pytest.mark.parametrize("quantizer", ["fake_quant", "fake_quant_tensor"])
def test_fake_quant_matches_reference_with_straight_through_grad(quantizer):
    x = np.random.default_rng(7).normal(scale=3.0, size=(64, 12)).astype(
        np.float32)
    want = np.asarray(getattr(j_quant, quantizer)(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = getattr(t_quant, quantizer)(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (g,) = torch.autograd.grad(got.sum(), xt)
    assert torch.equal(g, torch.ones_like(xt))


def test_adamw_and_schedule_match_reference():
    rng = np.random.default_rng(8)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(7,)).astype(np.float32)]
    gs = [[rng.normal(scale=2.0, size=a.shape).astype(np.float32)
           for a in p0] for _ in range(3)]
    jsched = j_sched(3e-3, warmup_steps=2, total_steps=3)
    tsched = t_sched(3e-3, warmup_steps=2, total_steps=3)
    jopt = JAdamW(weight_decay=1e-4, clip_norm=1.0)
    topt = TAdamW(weight_decay=1e-4, clip_norm=1.0)
    jp = [jnp.asarray(a) for a in p0]
    jstate = jopt.init(jp)
    tp = [torch.tensor(a) for a in p0]
    tstate = topt.init(tp)
    for step, g in enumerate(gs):
        lr = tsched(step)
        assert lr == pytest.approx(float(jsched(jnp.asarray(step))),
                                   rel=1e-6)
        jp, jstate = jopt.update([jnp.asarray(a) for a in g], jp, jstate,
                                 jsched(jnp.asarray(step)))
        tstate = topt.update([torch.tensor(a) for a in g], tp, tstate, lr)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
