"""The port's K3 (int4 matmul) and K4 (flash attention) plain versions
against the reference's Pallas kernels in interpret mode and its ``ref``
oracles, at the reference's test shapes and types and at the predictor's
shapes, with the tolerances of ``tests/test_kernels.py``; and the port's
device-side int4 packer against the reference's ``fake_quant_tensor``.
(The CUDA kernels themselves are held against these plain versions on the
card, in ``test_torch_cuda.py``.)"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quantize as j_quant
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core.quantize import pack_int4_like_fake_quant
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.int4_matmul import unpack_int4

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype):
    """The same float32 draws as a JAX and a torch array of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _np(a):
    return np.asarray(a.float() if torch.is_tensor(a) else
                      jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("b,h,hkv,sq,sk,d", [
    (1, 2, 1, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 1, 128, 384, 128),
    (1, 4, 4, 256, 128, 32),
    (2, 4, 4, 30, 30, 50),      # the Transformer family's heads
])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(b, h, hkv, sq, sk, d,
                                                 causal, dtype):
    rng = np.random.default_rng(b * h + sq + sk + d)
    jq, tq = _pair(rng.normal(size=(b, h, sq, d)).astype(np.float32), dtype)
    jk, tk = _pair(rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
                   dtype)
    jv, tv = _pair(rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
                   dtype)
    got = t_ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, sq, d)
    assert torch.equal(got, t_ref.flash_attention_ref(tq, tk, tv, causal))
    tol = 2e-4 if dtype == "float32" else 2e-2
    want = j_ref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    if not (causal and sq > sk):
        # the Pallas kernel skips key blocks wholly in a row's future, so
        # (as in the reference's own tests) it is held only where no row
        # sees no key at all
        pallas = j_ops.flash_attention(jq, jk, jv, causal=causal,
                                       block_q=min(128, sq),
                                       block_k=min(128, sk), interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), atol=tol)


@pytest.mark.parametrize("m,k,n", [(128, 128, 256), (128, 256, 256),
                                   (256, 128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_plain_matches_reference(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    jx, tx = _pair(rng.normal(size=(m, k)).astype(np.float32), dtype)
    w = rng.integers(0, 256, (k, n // 2)).astype(np.uint8)
    got = t_ops.int4_matmul(tx, torch.tensor(w), 0.03)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    assert torch.equal(got, t_ref.int4_matmul_ref(tx, torch.tensor(w), 0.03))
    tol = 1e-4 if dtype == "float32" else 2e-2
    for want in (j_ops.int4_matmul(jx, jnp.asarray(w), 0.03, interpret=True),
                 j_ref.int4_matmul_ref(jx, jnp.asarray(w), 0.03)):
        rel = np.abs(_np(got) - _np(want)) / (np.abs(_np(want)) + 1.0)
        assert rel.max() < tol


@pytest.mark.parametrize("m,k,n", [(60, 12, 12), (60, 12, 48), (60, 48, 12),
                                   (32, 12, 33)])
def test_int4_matmul_on_packed_predictor_weights(m, k, n):
    """The quantized simplified predictor's products (widths 12 and 48, a
    head with an odd class count padded by one zero column): K3's plain
    version on the packed weight equals the reference's Pallas kernel on the
    same bytes and ``x @ fake_quant_tensor(w)``."""
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.3).astype(np.float32)
    packed, scale = pack_int4_like_fake_quant(torch.tensor(w))
    assert packed.shape == (k, (n + 1) // 2) and packed.dtype == torch.uint8
    got = t_ops.int4_matmul(torch.tensor(x), packed, scale)[:, :n].numpy()
    pallas = np.asarray(j_ops.int4_matmul(
        jnp.asarray(x), jnp.asarray(packed.numpy()), float(scale),
        interpret=True))[:, :n]
    fq = np.asarray(jnp.asarray(x) @ j_quant.fake_quant_tensor(
        jnp.asarray(w)))
    for want in (pallas, fq):
        assert (np.abs(got - want) / (np.abs(want) + 1.0)).max() < 1e-4


@pytest.mark.parametrize("shape,scale", [((12, 12), 1.0), ((12, 48), 0.3),
                                         ((48, 12), 0.05), ((12, 37), 3.0)])
def test_packer_codes_are_fake_quant_codes(shape, scale):
    """``pack_int4_like_fake_quant(w)``, unpacked and multiplied by its
    scale, is the reference's ``fake_quant_tensor(w)`` to 1 ulp (the
    straight-through form ``w + (q - w)`` may round once more than ``q``),
    with its half-way points as float32 rounds them."""
    rng = np.random.default_rng(shape[1])
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    s = np.float32(np.abs(w).max()) / np.float32(8.0)
    w[0, :3] = np.float32([0.5, 1.5, -2.5]) * s     # half-way points
    packed, s_t = pack_int4_like_fake_quant(torch.tensor(w))
    assert s_t.dtype == torch.float32 and s_t.shape == ()
    got = (unpack_int4(packed).float() * s_t)[:, :shape[1]].numpy()
    want = np.asarray(j_quant.fake_quant_tensor(jnp.asarray(w)))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= ulp).all()
    assert (unpack_int4(packed)[:, shape[1]:] == 0).all()   # the padding
