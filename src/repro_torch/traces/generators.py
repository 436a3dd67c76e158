"""Algorithmic page-access generators for the paper's 11 GPU benchmarks.

Each generator derives per-CTA page-level access streams from the benchmark's
actual algorithm (row/column streaming for the Polybench matrix-vector
kernels, stencils for Hotspot/Srad/2DCONV, wavefront for NW, DP rows for
Pathfinder, layered phases for Backprop, pure streams for AddVectors /
StreamTriad).  The GPU execution model (gpu_model.py) schedules these CTAs
onto SMs and merges them into GMMU arrival order.

Array allocations are 2 MB aligned, mirroring ``cudaMallocManaged``; all
addresses are 4 KB page indices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.traces.trace import ROOT_PAGES

FLOAT = 4  # sizeof(float)
PAGE = 4096


@dataclasses.dataclass
class CTAStream:
    """Program-order page accesses issued by one CTA inside one kernel.

    `burst` is the mean number of consecutive GMMU requests this CTA issues
    before the SM scheduler switches away.  Streaming kernels with little
    compute per page (Polybench MV sweeps) issue long lockstep runs; stencil
    kernels with more compute per page are interrupted often.
    """

    kernel: int
    cta: int
    pcs: np.ndarray      # uint32, same length as pages
    arrays: np.ndarray   # uint16 array ids
    pages: np.ndarray    # int64 page indices
    burst: float = 24.0


@dataclasses.dataclass
class BenchmarkSpec:
    name: str
    streams: List[CTAStream]
    array_bases: Dict[str, int]   # array name -> base page
    array_pages: Dict[str, int]   # array name -> pages
    n_instructions: int

    @property
    def total_accesses(self) -> int:
        return sum(len(s.pages) for s in self.streams)


class _Alloc:
    """2MB-aligned bump allocator over virtual page space."""

    def __init__(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        # Random 2MB-aligned heap base, like a real VA layout.
        self.cursor = int(rng.integers(1 << 10, 1 << 20)) * ROOT_PAGES
        self.bases: Dict[str, int] = {}
        self.sizes: Dict[str, int] = {}
        self.ids: Dict[str, int] = {}

    def alloc(self, name: str, nbytes: int) -> int:
        pages = -(-nbytes // PAGE)
        base = self.cursor
        self.bases[name] = base
        self.sizes[name] = pages
        self.ids[name] = len(self.ids)
        # bump by whole 2MB chunks
        self.cursor += -(-pages // ROOT_PAGES) * ROOT_PAGES
        return base

    def aid(self, name: str) -> int:
        return self.ids[name]


def _pc(kernel: int, slot: int) -> int:
    """Deterministic PC for (kernel launch, static load/store slot)."""
    return 0x400000 + kernel * 0x1000 + slot * 0x20


def _stream(kernel: int, cta: int, parts: List[Tuple[int, int, np.ndarray]],
            burst: float = 24.0) -> CTAStream:
    """Build a CTAStream from (pc, array_id, pages) segments, interleaved in
    the given order element-wise when lengths match, else concatenated."""
    lens = {len(p[2]) for p in parts}
    if len(lens) == 1 and len(parts) > 1:
        n = lens.pop()
        k = len(parts)
        pcs = np.empty(n * k, np.uint32)
        arrs = np.empty(n * k, np.uint16)
        pages = np.empty(n * k, np.int64)
        for i, (pc, aid, pg) in enumerate(parts):
            pcs[i::k] = pc
            arrs[i::k] = aid
            pages[i::k] = pg
    else:
        pcs = np.concatenate([np.full(len(p[2]), p[0], np.uint32) for p in parts])
        arrs = np.concatenate([np.full(len(p[2]), p[1], np.uint16) for p in parts])
        pages = np.concatenate([p[2].astype(np.int64) for p in parts])
    return CTAStream(kernel, cta, pcs, arrs, pages, burst=burst)


def _row_pages(base: int, row: int, pages_per_row: int) -> np.ndarray:
    return base + row * pages_per_row + np.arange(pages_per_row, dtype=np.int64)


# ---------------------------------------------------------------------------
# Streaming kernels
# ---------------------------------------------------------------------------

def gen_addvectors(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """c[i] = a[i] + b[i]; CTAs own contiguous chunks of three streams."""
    n = int(8e6 * scale)  # elements
    al = _Alloc(seed)
    for name in ("a", "b", "c"):
        al.alloc(name, n * FLOAT)
    pages_per_cta = 16
    n_pages = al.sizes["a"]
    n_ctas = n_pages // pages_per_cta
    streams = []
    for cta in range(n_ctas):
        lo = cta * pages_per_cta
        idx = np.arange(lo, lo + pages_per_cta, dtype=np.int64)
        streams.append(_stream(0, cta, [
            (_pc(0, 0), al.aid("a"), al.bases["a"] + idx),
            (_pc(0, 1), al.aid("b"), al.bases["b"] + idx),
            (_pc(0, 2), al.aid("c"), al.bases["c"] + idx),
        ], burst=256.0))
    return BenchmarkSpec("AddVectors", streams, al.bases, al.sizes,
                         n_instructions=n * 3)


def gen_streamtriad(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """a[i] = b[i] + s * c[i] (STREAM triad)."""
    n = int(6e6 * scale)
    al = _Alloc(seed + 1)
    for name in ("a", "b", "c"):
        al.alloc(name, n * FLOAT)
    pages_per_cta = 8
    n_pages = al.sizes["a"]
    n_ctas = n_pages // pages_per_cta
    streams = []
    for cta in range(n_ctas):
        lo = cta * pages_per_cta
        idx = np.arange(lo, lo + pages_per_cta, dtype=np.int64)
        streams.append(_stream(0, cta, [
            (_pc(0, 0), al.aid("b"), al.bases["b"] + idx),
            (_pc(0, 1), al.aid("c"), al.bases["c"] + idx),
            (_pc(0, 2), al.aid("a"), al.bases["a"] + idx),
        ], burst=256.0))
    return BenchmarkSpec("StreamTriad", streams, al.bases, al.sizes,
                         n_instructions=n * 3)


# ---------------------------------------------------------------------------
# Polybench matrix-vector family (dominant-delta benchmarks)
# ---------------------------------------------------------------------------

def _mv_kernel(al: _Alloc, kernel: int, mat: str, n_rows: int,
               pages_per_row: int, rows_per_cta: int,
               col_block: int = 0) -> List[CTAStream]:
    """Polybench GPU matrix-vector kernels map one *thread per row*; a warp's
    coalesced lockstep sweep over the dot-product index therefore requests
    consecutive-row pages at a fixed column block — a constant page stride of
    +pages_per_row.  This single dominant delta (16384 B = 4 pages when rows
    are 16 KB) is exactly what the paper reports for ATAX/BICG/MVT (§5.3:
    99.26 % convergence).  Revisits of the same pages while the k-loop sweeps
    within a column block are absorbed by the SM TLB and never reach the
    GMMU.  Bursts are long: almost no compute per page."""
    streams = []
    n_ctas = n_rows // rows_per_cta
    for cta in range(n_ctas):
        r0 = cta * rows_per_cta
        rows = np.arange(r0, r0 + rows_per_cta, dtype=np.int64)
        pages = al.bases[mat] + rows * pages_per_row + col_block
        streams.append(_stream(kernel, cta,
                               [(_pc(kernel, col_block), al.aid(mat), pages)],
                               burst=512.0))
    return streams


def gen_atax(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """y = A^T (A x).  K0: tmp=Ax row-streams A; K1: y=A^T tmp column-sweeps A."""
    n = int(4096 * max(scale, 0.05))
    ppr = max(1, n * FLOAT // PAGE)           # pages per row (4 for n=4096)
    al = _Alloc(seed + 2)
    al.alloc("A", n * n * FLOAT)
    al.alloc("x", n * FLOAT)
    al.alloc("y", n * FLOAT)
    al.alloc("tmp", n * FLOAT)
    streams = []
    for kernel in (0, 1):  # tmp = A x; y = A^T tmp — both thread-per-row
        for blk in range(ppr):
            streams += _mv_kernel(al, kernel, "A", n, ppr, rows_per_cta=256,
                                  col_block=blk)
    return BenchmarkSpec("ATAX", streams, al.bases, al.sizes,
                         n_instructions=2 * n * n)


def gen_bicg(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """s = A^T r (column sweep); q = A p (row stream)."""
    n = int(4096 * max(scale, 0.05))
    ppr = max(1, n * FLOAT // PAGE)
    al = _Alloc(seed + 3)
    al.alloc("A", n * n * FLOAT)
    for v in ("r", "s", "p", "q"):
        al.alloc(v, n * FLOAT)
    streams = []
    for kernel in (0, 1):
        for blk in range(ppr):
            streams += _mv_kernel(al, kernel, "A", n, ppr, rows_per_cta=256,
                                  col_block=blk)
    return BenchmarkSpec("BICG", streams, al.bases, al.sizes,
                         n_instructions=2 * n * n)


def gen_mvt(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """x1 += A y1 (rows); x2 += A^T y2 (columns)."""
    n = int(4096 * max(scale, 0.05))
    ppr = max(1, n * FLOAT // PAGE)
    al = _Alloc(seed + 4)
    al.alloc("A", n * n * FLOAT)
    for v in ("x1", "x2", "y1", "y2"):
        al.alloc(v, n * FLOAT)
    streams = []
    for kernel in (0, 1):
        for blk in range(ppr):
            streams += _mv_kernel(al, kernel, "A", n, ppr, rows_per_cta=256,
                                  col_block=blk)
    return BenchmarkSpec("MVT", streams, al.bases, al.sizes,
                         n_instructions=2 * n * n)


# ---------------------------------------------------------------------------
# Rodinia kernels
# ---------------------------------------------------------------------------

def gen_backprop(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """Two-layer MLP (65536 -> 16): forward weight stream then backward
    adjust.  Phase change flips the array set and the stride pattern."""
    in_units = int(65536 * max(scale, 0.05))
    hid = 64
    epochs = 2
    al = _Alloc(seed + 5)
    al.alloc("input_units", in_units * FLOAT)
    al.alloc("w1", in_units * hid * FLOAT)
    al.alloc("delta_w1", in_units * hid * FLOAT)
    al.alloc("hidden_units", hid * FLOAT)
    w_pages = al.sizes["w1"]
    in_pages = al.sizes["input_units"]
    streams = []
    units_per_cta = 1024
    n_ctas = in_units // units_per_cta
    wpages_per_cta = w_pages // n_ctas
    ipages_per_cta = max(1, in_pages // n_ctas)
    for ep in range(epochs):
        kf, kb = ep * 2, ep * 2 + 1
        # forward: each CTA handles a block of input units, reading the
        # inputs and the corresponding hid-wide weight slab (row-major
        # in_units x hid).
        for cta in range(n_ctas):
            wp = al.bases["w1"] + cta * wpages_per_cta + np.arange(wpages_per_cta, dtype=np.int64)
            ip = al.bases["input_units"] + cta * ipages_per_cta + np.arange(ipages_per_cta, dtype=np.int64)
            streams.append(_stream(kf, cta, [
                (_pc(kf, 0), al.aid("input_units"), ip),
                (_pc(kf, 1), al.aid("w1"), wp),
            ]))
        # backward: adjust weights; w1 and delta_w1 interleaved.
        for cta in range(n_ctas):
            wp = al.bases["w1"] + cta * wpages_per_cta + np.arange(wpages_per_cta, dtype=np.int64)
            dp = al.bases["delta_w1"] + cta * wpages_per_cta + np.arange(wpages_per_cta, dtype=np.int64)
            streams.append(_stream(kb, cta, [
                (_pc(kb, 0), al.aid("w1"), wp),
                (_pc(kb, 1), al.aid("delta_w1"), dp),
            ]))
    return BenchmarkSpec("Backprop", streams, al.bases, al.sizes,
                         n_instructions=epochs * in_units * hid * 4)


def gen_hotspot(scale: float = 1.0, seed: int = 0, iters: int = 2) -> BenchmarkSpec:
    """2D 5-point stencil over temp/power grids; CTA tiles span 16 rows by one
    page-width of columns (1024 floats), ping-pong buffers across iterations."""
    n = int(2048 * max(scale, 0.1))
    ppr = max(1, n * FLOAT // PAGE)   # pages per grid row (2 for n=2048)
    tile = 16                         # rows per tile; cols per tile = 1 page
    al = _Alloc(seed + 6)
    al.alloc("temp_src", n * n * FLOAT)
    al.alloc("temp_dst", n * n * FLOAT)
    al.alloc("power", n * n * FLOAT)
    streams = []
    tiles_y = n // tile
    for it in range(iters):
        src, dst = ("temp_src", "temp_dst") if it % 2 == 0 else ("temp_dst", "temp_src")
        kernel = it
        for ty in range(tiles_y):
            for col_pg in range(ppr):
                cta = ty * ppr + col_pg
                r0 = ty * tile
                trows = np.arange(r0, r0 + tile, dtype=np.int64)
                # halo rows are touched first (shared-memory fill), then the
                # three arrays are read/written element-wise interleaved
                halo = np.array([max(r0 - 1, 0), min(r0 + tile, n - 1)],
                                dtype=np.int64)
                streams.append(_stream(kernel, cta, [
                    (_pc(kernel, 3), al.aid(src), al.bases[src] + halo * ppr + col_pg),
                ]))
                streams.append(_stream(kernel, cta, [
                    (_pc(kernel, 0), al.aid(src), al.bases[src] + trows * ppr + col_pg),
                    (_pc(kernel, 1), al.aid("power"), al.bases["power"] + trows * ppr + col_pg),
                    (_pc(kernel, 2), al.aid(dst), al.bases[dst] + trows * ppr + col_pg),
                ]))
    return BenchmarkSpec("Hotspot", streams, al.bases, al.sizes,
                         n_instructions=iters * n * n * 8)


def gen_nw(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """Needleman-Wunsch: anti-diagonal wavefront over the score matrix and the
    reference matrix; block (bi, bj) is processed at wave bi+bj."""
    n = int(1024 * max(scale, 0.1))
    tile = 16
    ppr = max(1, (n + 1) * FLOAT // PAGE)
    al = _Alloc(seed + 7)
    al.alloc("itemsets", (n + 1) * (n + 1) * FLOAT)
    al.alloc("reference", (n + 1) * (n + 1) * FLOAT)
    blocks = n // tile
    streams = []
    cta = 0
    for wave in range(2 * blocks - 1):
        kernel = 0 if wave < blocks else 1
        lo = max(0, wave - blocks + 1)
        hi = min(wave, blocks - 1)
        for bi in range(lo, hi + 1):
            bj = wave - bi
            r0 = bi * tile
            col_pg = (bj * tile * FLOAT) // PAGE
            rows = np.arange(r0, r0 + tile, dtype=np.int64)
            it_pages = al.bases["itemsets"] + rows * ppr + min(col_pg, ppr - 1)
            rf_pages = al.bases["reference"] + rows * ppr + min(col_pg, ppr - 1)
            streams.append(_stream(kernel, cta, [
                (_pc(kernel, 0), al.aid("itemsets"), it_pages),
                (_pc(kernel, 1), al.aid("reference"), rf_pages),
            ]))
            cta += 1
    return BenchmarkSpec("NW", streams, al.bases, al.sizes,
                         n_instructions=n * n * 6)


def gen_pathfinder(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """Row-by-row DP: each iteration reads the wall row and ping-pongs between
    two result buffers."""
    cols = int(200_000 * max(scale, 0.05))
    rows = 64
    al = _Alloc(seed + 8)
    al.alloc("wall", cols * rows * FLOAT)
    al.alloc("res_a", cols * FLOAT)
    al.alloc("res_b", cols * FLOAT)
    row_pages = max(1, cols * FLOAT // PAGE)
    pages_per_cta = 8
    n_ctas = row_pages // pages_per_cta
    streams = []
    for r in range(rows):
        src, dst = ("res_a", "res_b") if r % 2 == 0 else ("res_b", "res_a")
        for cta in range(n_ctas):
            off = cta * pages_per_cta + np.arange(pages_per_cta, dtype=np.int64)
            wall_pages = al.bases["wall"] + r * row_pages + off
            streams.append(_stream(r, cta, [
                (_pc(0, 0), al.aid("wall"), wall_pages),
                (_pc(0, 1), al.aid(src), al.bases[src] + off),
                (_pc(0, 2), al.aid(dst), al.bases[dst] + off),
            ], burst=64.0))
    return BenchmarkSpec("Pathfinder", streams, al.bases, al.sizes,
                         n_instructions=rows * cols * 3)


def gen_srad_v2(scale: float = 1.0, seed: int = 0, iters: int = 2) -> BenchmarkSpec:
    """SRAD v2: two stencil kernels per iteration over image J and the
    derivative/coefficient arrays; tiles span 16 rows by one page-width."""
    n = int(2048 * max(scale, 0.1))
    ppr = max(1, n * FLOAT // PAGE)
    tile = 16
    al = _Alloc(seed + 9)
    for name in ("J", "dN", "dS", "dW", "dE", "c"):
        al.alloc(name, n * n * FLOAT)
    tiles_y = n // tile
    streams = []
    for it in range(iters):
        for ty in range(tiles_y):
            for col_pg in range(ppr):
                cta = ty * ppr + col_pg
                r0 = ty * tile
                trows = np.arange(r0, r0 + tile, dtype=np.int64)
                halo = np.array([max(r0 - 1, 0), min(r0 + tile, n - 1)],
                                dtype=np.int64)
                k0 = it * 2
                streams.append(_stream(k0, cta, [
                    (_pc(k0, 3), al.aid("J"), al.bases["J"] + halo * ppr + col_pg),
                ]))
                streams.append(_stream(k0, cta, [
                    (_pc(k0, 0), al.aid("J"), al.bases["J"] + trows * ppr + col_pg),
                    (_pc(k0, 1), al.aid("dN"), al.bases["dN"] + trows * ppr + col_pg),
                    (_pc(k0, 2), al.aid("c"), al.bases["c"] + trows * ppr + col_pg),
                ]))
                k1 = it * 2 + 1
                streams.append(_stream(k1, cta, [
                    (_pc(k1, 0), al.aid("c"), al.bases["c"] + trows * ppr + col_pg),
                    (_pc(k1, 1), al.aid("dN"), al.bases["dN"] + trows * ppr + col_pg),
                    (_pc(k1, 2), al.aid("J"), al.bases["J"] + trows * ppr + col_pg),
                ]))
    return BenchmarkSpec("Srad-v2", streams, al.bases, al.sizes,
                         n_instructions=iters * n * n * 16)


def gen_2dconv(scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    """3x3 convolution: read rows r-1..r+1 of A, write row r of B."""
    n = int(2048 * max(scale, 0.1))
    ppr = max(1, n * FLOAT // PAGE)
    al = _Alloc(seed + 10)
    al.alloc("A", n * n * FLOAT)
    al.alloc("B", n * n * FLOAT)
    rows_per_cta = 4
    n_ctas = (n - 2) // rows_per_cta
    streams = []
    pg = np.arange(ppr, dtype=np.int64)
    for cta in range(n_ctas):
        r0 = 1 + cta * rows_per_cta
        for r in range(r0, r0 + rows_per_cta):
            streams.append(_stream(0, cta, [
                (_pc(0, 0), al.aid("A"), al.bases["A"] + (r - 1) * ppr + pg),
                (_pc(0, 1), al.aid("A"), al.bases["A"] + r * ppr + pg),
                (_pc(0, 2), al.aid("A"), al.bases["A"] + (r + 1) * ppr + pg),
                (_pc(0, 3), al.aid("B"), al.bases["B"] + r * ppr + pg),
            ], burst=64.0))
    return BenchmarkSpec("2DCONV", streams, al.bases, al.sizes,
                         n_instructions=n * n * 9)


BENCHMARKS: Dict[str, Callable[..., BenchmarkSpec]] = {
    "AddVectors": gen_addvectors,
    "ATAX": gen_atax,
    "Backprop": gen_backprop,
    "BICG": gen_bicg,
    "Hotspot": gen_hotspot,
    "MVT": gen_mvt,
    "NW": gen_nw,
    "Pathfinder": gen_pathfinder,
    "Srad-v2": gen_srad_v2,
    "StreamTriad": gen_streamtriad,
    "2DCONV": gen_2dconv,
}

# The 9 benchmarks used for predictor training tables (paper Tables 1-8).
PREDICTOR_BENCHMARKS = [
    "AddVectors", "ATAX", "Backprop", "BICG", "Hotspot",
    "MVT", "NW", "Pathfinder", "Srad-v2",
]


def generate_benchmark(name: str, scale: float = 1.0, seed: int = 0) -> BenchmarkSpec:
    if name not in BENCHMARKS:
        raise KeyError(f"unknown benchmark {name!r}; have {sorted(BENCHMARKS)}")
    return BENCHMARKS[name](scale=scale, seed=seed)
