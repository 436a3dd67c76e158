"""The port's K3 (int4 matmul) and K4 (flash attention) plain versions
against the reference's Pallas kernels in interpret mode and its ``ref``
oracles, at the reference's test shapes and types and at the predictor's
shapes, with the tolerances of ``tests/test_kernels.py``; the port's
device-side int4 packer against the reference's ``fake_quant_tensor``;
which variant of K3 and which tiling of K2 and K4 each shape takes; and a
model of K1's victim search over chunk bounds against ``argmin`` over the
span, the rule of K1's plain version.
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
from repro_torch.kernels import hlsh_attention as k2
from repro_torch.kernels.flash_attention import (WARP_HEADS, WARP_MAX_D,
                                                 WARP_ROWS, flash_geometry)
from repro_torch.kernels.lane_replay import (BLK_PAGES, ROOT_PAGES,
                                             check_quota_boundaries,
                                             lane_replay)
from repro_torch.kernels.int4_matmul import (VARIANTS, WIDE_MAX_ROWS,
                                             int4_variant, unpack_int4)

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


#: (M, K, N, dtype) -> K3's body: the path's layer products and head, the
#: reference's shapes, the edges of each variant, and every body in each type
INT4_VARIANT_CASES = [
    (122880, 12, 12, "float32", "narrow16"),
    (122880, 12, 48, "float32", "narrow48x2"),
    (122880, 48, 12, "float32", "narrow16"),
    (4096, 12, 20000, "float32", "wide16"),
    (4096, 12, 20000, "bfloat16", "wide16"),
    (128, 128, 256, "float32", "general"),
    (128, 256, 256, "bfloat16", "general"),
    (256, 128, 512, "float32", "general"),
    (1000, 64, 64, "float32", "narrow64"),
    (1000, 48, 48, "bfloat16", "narrow48"),
    (1000, 12, 12, "bfloat16", "general"),     # rows of 24 bytes
    (1000, 13, 12, "float32", "general"),      # odd K
    (1000, 12, 14, "float32", "general"),      # rows of out of 56 bytes
    (1000, 65, 12, "float32", "general"),
    (1000, 12, 66, "float32", "general"),
    (1000, 32, 68, "float32", "wide32"),
    (1000, 33, 20000, "float32", "general"),   # K x 4 weights > 128
    (1000, 16, 20000, "bfloat16", "wide16"),
    (1000, 17, 20000, "bfloat16", "general"),
    (1000, 48, 32, "float32", "narrow32"),
    (1000, 12, 24, "float32", "narrow32x2"),
    (1000, 48, 48, "float32", "narrow48"),
    (1000, 16, 16, "bfloat16", "narrow16"),
    (1000, 48, 32, "bfloat16", "narrow32"),
    (1000, 16, 32, "bfloat16", "narrow32x2"),
    (1000, 32, 48, "bfloat16", "narrow48x2"),
    (1000, 40, 48, "bfloat16", "narrow48"),    # x rows of 5 chunks
    (1000, 64, 64, "bfloat16", "narrow64"),
    (WIDE_MAX_ROWS, 12, 20000, "float32", "wide16"),
    (WIDE_MAX_ROWS + 1, 12, 20000, "float32", "general"),  # grid.y full
    (WIDE_MAX_ROWS + 1, 12, 12, "float32", "narrow16"),    # persistent
]


@pytest.mark.parametrize("m,k,n,dtype,variant", INT4_VARIANT_CASES)
def test_int4_variant_by_shape(m, k, n, dtype, variant):
    assert int4_variant(m, k, n, DTYPES[dtype][1]) == variant


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_variant_cases_reach_every_body(dtype):
    """The shapes above reach every compiled body of K3 in each type (the
    wide body of K <= 32 is float32's only)."""
    reached = {c[4] for c in INT4_VARIANT_CASES if c[3] == dtype}
    want = set(VARIANTS) - ({"wide32"} if dtype == "bfloat16" else set())
    assert reached == want


@pytest.mark.parametrize("x_ptr,out_ptr,narrow,wide", [
    (0, 0, "narrow16", "wide16"), (4, 0, "general", "wide16"),
    (0, 8, "general", "general"), (16, 32, "narrow16", "wide16")])
def test_int4_variant_by_pointer(x_ptr, out_ptr, narrow, wide):
    """An x pointer off 16 bytes sends the narrow variant's shapes to the
    general one (the wide one reads x by scalars); an output pointer off 16
    bytes sends both there."""
    assert int4_variant(1000, 12, 12, torch.float32, x_ptr, out_ptr) == narrow
    assert int4_variant(1000, 12, 20000, torch.float32, x_ptr,
                        out_ptr) == wide


@pytest.mark.parametrize("bh,sq,sk,d,want", [
    (16384, 30, 30, 50, ("warp", 2)),          # the Transformer family's
    (2, 128, 128, 64, ("general", 1)),         # the reference's shapes
    (8, 256, 256, 64, ("general", 1)),
    (8, 128, 384, 128, ("general", 1)),
    (4, 256, 128, 32, ("general", 1)),
    (3, 1, 1, 1, ("warp", 2)),
    (10, 30, 33, 50, ("general", 1)),          # 33 keys
    (10, 30, 30, 65, ("general", 1)),
])
def test_flash_geometry_at_the_path_and_reference_shapes(bh, sq, sk, d,
                                                         want):
    assert tuple(flash_geometry(bh, sq, sk, d)) == want


@pytest.mark.parametrize("s", (1, 29, 30, 31, 33, 129, 384))
@pytest.mark.parametrize("d", (1, 49, 50, 64, 100, 128))
def test_flash_geometry_fits_the_kernel(s, d):
    """K4 takes the warp-per-head tiling exactly where a head's queries and
    keys fit a warp's register tiles (S <= 32, D <= 64), with 2 heads a
    block (1 where there is one head); everything else is general."""
    fits = s <= WARP_ROWS and d <= WARP_MAX_D
    assert flash_geometry(10, s, s, d) == (("warp", WARP_HEADS) if fits
                                           else ("general", 1))
    assert flash_geometry(1, s, s, d).heads == 1


@pytest.mark.parametrize("b,n,d,dtype,want", [
    (4096, 30, 12, torch.float32, ("warp", 4)),     # the predictor's path
    (4096, 30, 12, torch.bfloat16, ("warp", 4)),
    (1, 128, 32, torch.float32, ("general", 1)),    # the reference's shapes
    (2, 256, 64, torch.float32, ("general", 1)),
    (1, 512, 128, torch.bfloat16, ("general", 1)),
    (3, 70, 33, torch.float32, ("general", 1)),
    (2, 30, 12, torch.float32, ("warp", 2)),        # fewer rows than a block
    (64, 32, 64, torch.float32, ("warp", 2)),       # 24 KB of shared a row
    (64, 33, 12, torch.float32, ("general", 1)),
    (64, 30, 65, torch.float32, ("general", 1)),
])
def test_hlsh_geometry_at_the_path_and_reference_shapes(b, n, d, dtype, want):
    assert tuple(k2.hlsh_geometry(b, n, d, dtype)) == want


@pytest.mark.parametrize("n", (1, 2, 31, 32, 33, 128))
@pytest.mark.parametrize("d", (1, 7, 12, 64, 65, 128))
def test_hlsh_geometry_fits_the_kernel(n, d):
    """K2 takes the warp-per-row tiling exactly where a row's queries and
    keys fit one warp (N <= 32, D <= 64), with as many rows a block as its
    float32 staging of q, k and v fits in 48 KB (at most 4); everything
    else is general."""
    geo = k2.hlsh_geometry(100, n, d, torch.float32)
    if n <= k2.WARP_N and d <= k2.WARP_MAX_D:
        assert geo.tiling == "warp" and 1 <= geo.rows <= k2.WARP_ROWS
        assert 3 * 4 * (-(-n * d // 4) * 4) * geo.rows <= k2.WARP_SMEM
    else:
        assert geo == ("general", 1)
    with pytest.raises(ValueError):
        k2.hlsh_geometry(100, n, d, torch.float16)


_IMAX64 = 2 ** 63 - 1
_NONE = 2 ** 64 - 1          # the kernel's ~0: a chunk with nothing resident


class ChunkSearch:
    """A model of K1's victim search (``csrc/lane_replay.cu``): a lower bound
    of each chunk's least victim key, lowered by every insertion and left
    alone by retouches and evictions; a search scans the chunk it starts
    at, makes that chunk's bound exact, and stops when it is below every
    other bound of the range (ties to the lower chunk), else moves to the
    chunk of the least bound."""

    def __init__(self, span, policy):
        self.span, self.policy = span, policy
        self.bound = [_NONE] * -(-span // ROOT_PAGES)
        self.cur, self.scans = 0, 0

    def key(self, i, stamp, freq, prio):
        if self.policy == "random":
            return (int(prio[i]) << 21) | i
        if self.policy == "hotcold":
            return (int(freq[i]) << 32) | int(stamp[i])
        return (int(stamp[i]) << 32) | i

    def insert(self, i, stamp, freq, prio):
        c = i // ROOT_PAGES
        self.bound[c] = min(self.bound[c], self.key(i, stamp, freq, prio))

    def search(self, lo, hi, resident, stamp, freq, prio):
        c_lo = lo // ROOT_PAGES
        c_hi = -(-hi // ROOT_PAGES) if hi > lo else c_lo
        if not c_lo <= self.cur < c_hi:
            self.cur = c_lo
        while True:
            cur = self.cur
            slots = range(cur * ROOT_PAGES, min((cur + 1) * ROOT_PAGES, hi))
            ka, ia = min(((self.key(i, stamp, freq, prio), i) for i in slots
                          if resident[i]), default=(_NONE, None))
            kb, ib = min(((self.bound[c], c) for c in range(c_lo, c_hi)
                          if c != cur), default=(_NONE, None))
            self.scans += 1
            self.bound[cur] = ka
            if ib is None or (ka, cur) < (kb, ib):
                return ia
            self.cur = ib


def _argmin_victim(policy, lo, hi, resident, stamp, freq, prio):
    """K1's plain version's rule: ``argmin`` of the policy key over the
    span, non-resident slots and those outside the tenant's range at the
    largest key (the first index on ties)."""
    iota = torch.arange(len(resident), dtype=torch.int64)
    res = torch.as_tensor(resident) & (iota >= lo) & (iota < hi)
    if policy == "random":
        key = (torch.as_tensor(prio) << 21) | iota
    elif policy == "hotcold":
        key = (torch.as_tensor(freq) << 32) | torch.as_tensor(stamp)
    else:
        key = torch.as_tensor(stamp)
    return int(torch.argmin(torch.where(res, key, _IMAX64)))


@pytest.mark.parametrize("policy", ["lru", "random", "hotcold"])
@pytest.mark.parametrize("span", [700, 3000, 4096])
@pytest.mark.parametrize("tenants", [False, True])
def test_chunk_search_picks_the_argmin_victim(policy, span, tenants):
    """Random insertions (single pages and root-window bursts stamped in
    rank order, as a tree emission stamps them), retouches (a new stamp;
    hotcold also counts a touch, so freqs tie often) and evictions over a
    span that is or is not a multiple of 512, with and without a tenant
    boundary on a chunk edge: the chunk search evicts argmin's victim every
    time, scanning a few chunks per eviction, not the span."""
    rng = np.random.default_rng(span + 7 * tenants
                                + ("lru", "random", "hotcold").index(policy))
    bnd = ROOT_PAGES if tenants else span
    stamp = np.zeros(span, dtype=np.int64)
    freq = np.zeros(span, dtype=np.int64)
    prio = np.zeros(span, dtype=np.int64)
    resident = np.zeros(span, dtype=bool)
    model = ChunkSearch(span, policy)
    counter = evictions = 0
    for _ in range(3000):
        op = rng.random()
        if op < 0.45:                    # insert: a page, or a root burst
            if rng.random() < 0.2:
                root = int(rng.integers(0, -(-span // ROOT_PAGES)))
                idx = [i for i in range(root * ROOT_PAGES,
                                        min(span, (root + 1) * ROOT_PAGES))
                       if not resident[i] and rng.random() < 0.3]
            else:
                i = int(rng.integers(0, span))
                idx = [] if resident[i] else [i]
            for rank, i in enumerate(idx):
                resident[i] = True
                stamp[i], freq[i] = counter + rank, 0
                prio[i] = int(rng.integers(0, 2 ** 32))
                model.insert(i, stamp, freq, prio)
            counter += len(idx)
        elif op < 0.75:                  # retouch a resident page
            live = np.flatnonzero(resident)
            if len(live):
                i = int(rng.choice(live))
                stamp[i] = counter
                freq[i] += 1
                counter += 1
        else:                            # evict from a tenant's range
            lo, hi = ((0, bnd) if not tenants or rng.random() < 0.5
                      else (bnd, span))
            if not resident[lo:hi].any():
                continue
            want = _argmin_victim(policy, lo, hi, resident, stamp, freq,
                                  prio)
            got = model.search(lo, hi, resident, stamp, freq, prio)
            assert got == want
            resident[got] = False
            evictions += 1
    assert evictions > 300
    assert model.scans < 4 * evictions


def test_quota_boundaries_must_lie_on_chunk_edges():
    """Each tenant's slots must be whole chunks of K1's victim search: the
    wrapper refuses a quota lane whose tenant boundary is off a chunk edge
    (a shared-capacity lane, q0 = -1, may have any boundary)."""
    ip = torch.full((3, 9), -1, dtype=torch.int32)
    ip[:, 6] = torch.tensor([2 * ROOT_PAGES, -ROOT_PAGES, 700])
    ip[:2, 7] = 10
    check_quota_boundaries(ip)
    ip[2, 7] = 10
    with pytest.raises(ValueError, match="chunk edges"):
        check_quota_boundaries(ip)


@pytest.mark.parametrize("family,span,ok", [
    ("demand", 3008, True), ("oracle", 3008, True), ("tree", 3072, True),
    ("tree", 3008, False), ("learned", 3000, False)])
def test_spans_hold_whole_blocks_and_tree_roots(family, span, ok):
    """A block DMA reads its fault's whole 16-page block and a tree fault
    its whole 512-page root window, so K1 and its plain version refuse a
    span that would cut one (the sweep's spans are whole root windows)."""
    pages = torch.zeros((1, 4), dtype=torch.int32)
    fparams = torch.ones((1, 8), dtype=torch.float64)
    iparams = torch.tensor([[4, -1, 16, 0, 0, 0, 2 ** 31 - 1, -1, -1]],
                           dtype=torch.int32)
    kw = dict(family=family, lookahead=1 if family == "oracle" else 0,
              ft=torch.full((1, 4), span, dtype=torch.int32),
              pos=torch.zeros((1, 4), dtype=torch.int32))
    preds = torch.full((1, 4), -1, dtype=torch.int32)
    if ok:
        out = lane_replay(pages, preds, fparams, iparams, span, 17, **kw)
        assert out.shape == (1, 10) and out[0, 3] == 1     # one fault
    else:
        whole = ROOT_PAGES if family == "tree" else BLK_PAGES
        with pytest.raises(ValueError, match=f"multiple of {whole}"):
            lane_replay(pages, preds, fparams, iparams, span, 17, **kw)
