"""``cuda`` multi-lane replay backend: the host side of kernel K1.

Mirrors the host code of the reference's Pallas backend
(``repro.uvm.backends.pallas_backend``): many compatible sweep cells pack
into one lane batch, one lane per cell, traces padded to the longest lane,
with the same ``fparams``/``iparams`` parameter blocks, the same oracle
input streams and the same stats layout.  The kernel
(``repro_torch.kernels.lane_replay``) runs one thread block per lane on the
card.

This backend replays every lane family (``demand``, ``tree``, ``learned``,
``oracle``) under the ``lru``, ``random`` and ``hotcold`` eviction
policies, single-tenant or two-tenant (shared capacity or hard per-tenant
quotas), with or without step clocks (``ReplayRequest.step_bounds``).
:func:`decline_reason` names why it declines a request (timelines, lanes
past the kernel's ceilings); :meth:`CudaReplayBackend.replay` raises on
such a request, and ``replay_core.dispatch`` sends it down the chain to
the NumPy chunked engine instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels.lane_replay import (LANE_INFO_FIELDS,
                                             MAX_LANE_STEPS,
                                             MAX_ORACLE_LOOKAHEAD,
                                             N_FPARAMS, N_IPARAMS,
                                             STAT_FIELDS, lane_replay)
from repro_torch.traces.trace import ROOT_PAGES
from repro_torch.uvm import faults
from repro_torch.uvm.eviction import resolve_tenancy
from repro_torch.uvm.prefetchers import (BlockPrefetcher, LearnedPrefetcher,
                                         NoPrefetcher, OraclePrefetcher,
                                         Prefetcher, TreePrefetcher)
from repro_torch.uvm.replay_core import (ReplayBackend, ReplayRequest,
                                         UVMStats, _tenant_accesses,
                                         cycles_per_access, dense_bounds)

#: lane-family kind per exact prefetcher type (the reference's map)
FAMILY_BY_TYPE = {
    NoPrefetcher: "demand",
    BlockPrefetcher: "demand",
    TreePrefetcher: "tree",
    LearnedPrefetcher: "learned",
    OraclePrefetcher: "oracle",
}

#: lane families and eviction policies K1 replays
PORTED_FAMILIES = ("demand", "tree", "learned", "oracle")
PORTED_POLICIES = ("lru", "random", "hotcold")

#: hard per-lane page-span ceiling
MAX_LANE_SPAN_PAGES = 1 << 20

#: lane-batch shape budgets: lanes per kernel launch, total padded state
#: (lanes x span pages) and total padded trace positions (lanes x t_max)
MAX_LANES_PER_BATCH = 32
MAX_BATCH_STATE_PAGES = 1 << 23
MAX_BATCH_ACCESSES = 1 << 24

#: per-lane trace-length ceilings: the kernel's stamps and touch counter
#: are int32.  Demand/learned/oracle lanes grow the counter by at most
#: 1 + 16 + 16 (+1 in-flight retouch) per access (2^24 * 34 < 2^31); a tree
#: fault can stamp a whole 2 MB root window (up to 512 per access), so tree
#: lanes cap at 2^21 (2^21 * 513 < 2^31).
MAX_LANE_ACCESSES = MAX_BATCH_ACCESSES
MAX_TREE_LANE_ACCESSES = 1 << 21
_FAMILY_MAX_ACCESSES = {"demand": MAX_LANE_ACCESSES,
                        "tree": MAX_TREE_LANE_ACCESSES,
                        "learned": MAX_LANE_ACCESSES,
                        "oracle": MAX_LANE_ACCESSES}

_IMAX = 2 ** 31 - 1


def lane_family(pf: Prefetcher) -> Optional[str]:
    """Lane-family bucket of a prefetcher, or None when unpackable (exact
    type: subclasses are unpackable, as in the reference).  Oracle lanes
    carry their lookahead, so a batch never mixes window widths."""
    family = FAMILY_BY_TYPE.get(type(pf))
    if family == "oracle":
        return f"oracle/{int(pf.lookahead)}"
    return family


def _bucket(n: int, floor: int) -> int:
    """Round up to the next power of two (>= floor)."""
    b = max(floor, 1)
    while b < n:
        b <<= 1
    return b


def _lane_shape(request: ReplayRequest) -> Tuple[str, str, int, int]:
    """(group, eviction policy, length, span) of one request's lane.  The
    group is the lane family, marked ``+steps`` for a step-clock lane and
    ``+quotas`` for a quota lane, so the packer keeps K1's variants in
    batches of their own."""
    lo, hi = dense_bounds(request.trace, request.prefetcher)
    group = lane_family(request.prefetcher) or "unpackable"
    if request.step_bounds is not None:
        group += "+steps"
    tenancy = resolve_tenancy(request.trace, request.config)
    if tenancy is not None and tenancy.split:
        group += "+quotas"
    return group, request.config.eviction, len(request.trace.pages), hi - lo


def _step_bounds_reason(request: ReplayRequest) -> Optional[str]:
    """Why K1 cannot capture ``request``'s step clocks, or None."""
    sb = np.asarray(request.step_bounds)
    if (sb.ndim != 1 or sb.size == 0 or not np.issubdtype(sb.dtype,
                                                          np.integer)):
        return (f"step_bounds must be a non-empty 1-D integer array, got "
                f"{sb.dtype} {sb.shape}")
    if (np.any(np.diff(sb) < 0) or sb[0] < 0
            or sb[-1] > len(request.trace.pages)):
        return ("step_bounds must be non-decreasing end indices <= "
                "n_accesses")
    if sb.size > MAX_LANE_STEPS:
        return (f"{sb.size} step windows outside 1..{MAX_LANE_STEPS} (K1's "
                "per-lane window clocks)")
    return None


def decline_reason(request: ReplayRequest) -> Optional[str]:
    """Why K1 cannot replay ``request``, or None if it can."""
    pf = request.prefetcher
    family = lane_family(pf)
    if family is None:
        return f"prefetcher {type(pf).__name__} has no lane family"
    kind = family.split("/")[0]
    if request.config.eviction not in PORTED_POLICIES:
        return (f"eviction={request.config.eviction!r} is not a K1 policy "
                f"({', '.join(PORTED_POLICIES)}); the sweep resolves the "
                "adaptive pseudo-policy before the replay")
    if request.record_timeline:
        return "K1 records no per-transfer timeline"
    if request.step_bounds is not None:
        reason = _step_bounds_reason(request)
        if reason is not None:
            return reason
    try:
        resolve_tenancy(request.trace, request.config)
    except ValueError as e:
        return f"invalid tenancy: {e}"
    cap = request.config.device_pages
    if cap is not None and not 0 <= cap <= _IMAX:
        return (f"device_pages={cap} outside K1's int32 parameter block "
                f"(0..{_IMAX})")
    n = len(request.trace.pages)
    if n == 0 or n > _FAMILY_MAX_ACCESSES[kind]:
        return (f"trace length {n} outside 1..{_FAMILY_MAX_ACCESSES[kind]} "
                f"(the {kind} family's int32 stamp ceiling)")
    if kind == "learned" and len(pf.predicted_pages) < n:
        return "the learned decision stream is shorter than the trace"
    if kind == "oracle" and not 0 < pf.lookahead <= MAX_ORACLE_LOOKAHEAD:
        return (f"oracle lookahead {pf.lookahead} outside "
                f"1..{MAX_ORACLE_LOOKAHEAD} (one thread per window entry)")
    lo, hi = dense_bounds(request.trace, pf)
    if lo < 0 or hi - lo > min(request.max_span_pages, MAX_LANE_SPAN_PAGES):
        return f"page span [{lo}, {hi}) outside the lane ceiling"
    return None


def lane_info_buffer(n_lanes: int, device) -> torch.Tensor:
    """A zeroed ``lane_info`` for K1: one row a lane, one int64 column for
    each of ``LANE_INFO_FIELDS``."""
    return torch.zeros((n_lanes, len(LANE_INFO_FIELDS)), dtype=torch.int64,
                       device=device)


def count_lane_info(requests: Sequence[ReplayRequest], info: np.ndarray,
                    raw: np.ndarray) -> None:
    """Add one batch to the traced pass's ``k1.lane_*`` counters: ``info``
    is K1's ``lane_info`` and ``raw`` its stats, both for the real lanes
    (``requests``) only.  ``k1.lane_evictions`` sums the lanes' evictions,
    of which rounds made ``k1.lane_round_evictions``."""
    col = {f: info[:, i] for i, f in enumerate(LANE_INFO_FIELDS)}
    spans.count("k1.lane_accesses",
                sum(len(r.trace.pages) for r in requests))
    spans.count("k1.lane_scans", int(col["scans"].sum()))
    spans.count("k1.lane_ns_sum", int(col["ns"].sum()))
    spans.count("k1.lane_ns_longest_x_lanes",
                int(col["ns"].max()) * len(requests))
    spans.count("k1.lane_rounds", int(col["rounds"].sum()))
    spans.count("k1.lane_round_evictions", int(col["round_evictions"].sum()))
    spans.count("k1.lane_evictions",
                int(raw[:, STAT_FIELDS.index("pages_evicted")].sum()))


@dataclasses.dataclass
class LaneBatch:
    """The kernel inputs of one homogeneous lane batch, as numpy arrays
    (``preds`` only for learned lanes, ``ft``/``pos`` only for oracle
    lanes)."""

    family: str                  # kernel kind: demand/tree/learned/oracle
    policy: str
    pages: np.ndarray
    fparams: np.ndarray
    iparams: np.ndarray
    span: int
    buf_len: int
    preds: Optional[np.ndarray] = None
    ft: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None
    lookahead: int = 0
    #: step-clock batches: the window id of every access
    sids: Optional[np.ndarray] = None
    steps_len: int = 0
    #: a lane of the batch has per-tenant quotas
    quotas: bool = False

    @spans.spanned("cuda_backend.to_device")
    def kernel_args(self, device) -> Dict:
        """Keyword arguments of :func:`lane_replay` on ``device``."""
        dev = torch.device(device)

        def t(a):
            return None if a is None else torch.as_tensor(a, device=dev)
        return dict(pages=t(self.pages), preds=t(self.preds),
                    fparams=t(self.fparams), iparams=t(self.iparams),
                    span=self.span, buf_len=self.buf_len,
                    family=self.family, policy=self.policy, ft=t(self.ft),
                    pos=t(self.pos), lookahead=self.lookahead,
                    sids=t(self.sids), steps_len=self.steps_len,
                    quotas=self.quotas)


class CudaReplayBackend(ReplayBackend):
    name = "cuda"

    def can_replay(self, request: ReplayRequest) -> bool:
        return decline_reason(request) is None

    @staticmethod
    def fits_batch(shapes: Sequence[Tuple[str, str, int, int]],
                   shape: Tuple[str, str, int, int]) -> bool:
        """True if a lane of ``shape`` fits a batch that already holds lanes
        of ``shapes``: family- and policy-homogeneous, within the lane-count,
        padded-state and padded-access budgets."""
        fam, pol, t, sp = shape
        if any(f != fam or p != pol for f, p, _, _ in shapes):
            return False
        n = len(shapes) + 1
        t = max([t] + [s[2] for s in shapes])
        sp = max([sp] + [s[3] for s in shapes])
        return (n <= MAX_LANES_PER_BATCH
                and n * sp <= MAX_BATCH_STATE_PAGES
                and n * t <= MAX_BATCH_ACCESSES)

    @spans.spanned("cuda_backend.pack_lanes")
    def pack_lanes(self, requests: Sequence[ReplayRequest]
                   ) -> List[List[int]]:
        """Group request indices into homogeneous lane batches: sorted by
        (family, policy, length, span), then packed greedily under
        :meth:`fits_batch`.  Deterministic in the request order."""
        order = sorted(range(len(requests)),
                       key=lambda i: _lane_shape(requests[i]), reverse=True)
        batches: List[List[int]] = []
        cur: List[int] = []
        cur_shapes: List[Tuple[str, str, int, int]] = []
        for i in order:
            shape = _lane_shape(requests[i])
            if cur and not self.fits_batch(cur_shapes, shape):
                batches.append(cur)
                cur, cur_shapes = [], []
            cur.append(i)
            cur_shapes.append(shape)
        if cur:
            batches.append(cur)
        return batches

    def replay(self, requests: Sequence[ReplayRequest]) -> List[UVMStats]:
        for req in requests:
            reason = decline_reason(req)
            if reason is not None:
                raise ValueError(f"cuda backend cannot replay "
                                 f"{req.trace.name}: {reason} "
                                 "(replay_core.dispatch sends such a "
                                 "request down the backend chain)")
        if requests:
            # an injected raise here is a TransientBackendFault: it leaves
            # the sweep, which retries the cell on K1, never on another
            # backend
            faults.fire("backend.replay",
                        f"{len(requests)}:{requests[0].trace.name}")
        out: List[UVMStats] = [None] * len(requests)  # type: ignore
        for batch in self.pack_lanes(requests):
            for i, stats in zip(batch, self._replay_batch(
                    [requests[i] for i in batch])):
                out[i] = stats
        return out

    @spans.spanned("cuda_backend.pack_batch")
    def pack_batch(self, requests: Sequence[ReplayRequest]) -> LaneBatch:
        """The kernel inputs of one homogeneous lane batch."""
        families = {lane_family(r.prefetcher) for r in requests}
        policies = {r.config.eviction for r in requests}
        if len(families) != 1 or len(policies) != 1:
            raise ValueError(f"lane batch must be family- and policy-"
                             f"homogeneous, got {families} / {policies}")
        family = families.pop()
        kind = family.split("/")[0]
        lookahead = int(family.split("/")[1]) if kind == "oracle" else 0
        lanes = len(requests)
        shapes = [_lane_shape(r) for r in requests]
        t_max = _bucket(max(t for _, _, t, _ in shapes), 64)
        span = _bucket(max(s for _, _, _, s in shapes), ROOT_PAGES)
        buf_len = max(int(r.config.mshr_entries) for r in requests) + 1
        n_lanes = _bucket(lanes, 1)
        step_sizes = [0 if r.step_bounds is None
                      else int(np.asarray(r.step_bounds).size)
                      for r in requests]
        steps_len = _bucket(max(step_sizes), 64) if any(step_sizes) else 0
        tenancies = [resolve_tenancy(r.trace, r.config) for r in requests]

        batch = LaneBatch(
            family=kind, policy=policies.pop(),
            pages=np.zeros((n_lanes, t_max), dtype=np.int32),
            fparams=np.zeros((n_lanes, N_FPARAMS), dtype=np.float64),
            iparams=np.full((n_lanes, N_IPARAMS), -1, dtype=np.int32),
            span=span, buf_len=buf_len, lookahead=lookahead,
            steps_len=steps_len,
            quotas=any(tn is not None and tn.split for tn in tenancies))
        iparams = batch.iparams
        iparams[:, 0] = 0                       # padding lanes replay nothing
        iparams[:, 6] = np.iinfo(np.int32).max  # single-tenant boundary
        if kind == "learned":
            batch.preds = np.full((n_lanes, t_max), -1, dtype=np.int32)
        if kind == "oracle":
            # padded first-touch entries point at the trash slot ``span``
            ft_len = _bucket(max(len(r.prefetcher.ft_pages)
                                 for r in requests), 64) + lookahead
            batch.ft = np.full((n_lanes, ft_len), span, dtype=np.int32)
            batch.pos = np.zeros((n_lanes, t_max), dtype=np.int32)
        if steps_len:
            batch.sids = np.zeros((n_lanes, t_max), dtype=np.int32)
        for lane, req in enumerate(requests):
            trace, cfg, pf = req.trace, req.config, req.prefetcher
            pf.reset()
            n = len(trace.pages)
            lo, _ = dense_bounds(trace, pf)
            batch.pages[lane, :n] = np.asarray(trace.pages,
                                               dtype=np.int64) - lo
            batch.fparams[lane] = (
                cycles_per_access(trace, cfg), cfg.page_transfer_cycles,
                cfg.far_fault_cycles, cfg.page_table_walk_cycles,
                cfg.pcie_latency_cycles, cfg.prefetch_overhead_cycles,
                pf.extra_latency_cycles, cfg.page_size)
            has_block = (type(pf) is BlockPrefetcher
                         or (type(pf) is LearnedPrefetcher
                             and pf.prefetch_block))
            iparams[lane, :4] = (
                n, -1 if cfg.device_pages is None else int(cfg.device_pages),
                int(cfg.mshr_entries), 1 if has_block else 0)
            # lane lo mod 2^32 (int32 bit pattern): random-policy draws
            # hash the absolute page id, identical across backends
            iparams[lane, 5] = np.array(lo & 0xFFFFFFFF,
                                        dtype=np.uint32).astype(np.int32)
            tn = tenancies[lane]
            if tn is not None:
                # dense boundary (may fall outside [0, span) when the slice
                # touches one tenant only: the compares stay correct)
                iparams[lane, 6] = int(tn.boundary) - lo
                if tn.split:
                    iparams[lane, 7:9] = tn.quotas
            if req.step_bounds is not None:
                sb = np.asarray(req.step_bounds, dtype=np.int64)
                # window id per access; accesses past the last bound go to
                # the trash slot ``steps_len``
                sid = np.searchsorted(sb, np.arange(n), side="right")
                batch.sids[lane, :n] = np.where(sid >= sb.size, steps_len,
                                                sid)
            if kind == "learned":
                pr = np.asarray(pf.predicted_pages, dtype=np.int64)[:n]
                batch.preds[lane, :n] = np.where(pr >= 0, pr - lo, -1)
            if kind == "oracle":
                ftp = np.asarray(pf.ft_pages, dtype=np.int64) - lo
                batch.ft[lane, :len(ftp)] = ftp
                # the stream position only ever advances with the access
                # index: precompute it per access
                batch.pos[lane, :n] = np.searchsorted(
                    pf.ft_index, np.arange(n), side="right")
                iparams[lane, 4] = len(ftp)
        return batch

    def _replay_batch(self, requests: Sequence[ReplayRequest]
                      ) -> List[UVMStats]:
        """Replay one homogeneous lane batch: pack, launch, unpack.  While
        a pass is traced on the card, K1 also writes each lane's chunk
        scans, nanoseconds, rounds and round evictions (``lane_info``),
        which go to the pass's ``k1.lane_*`` counters (padding lanes left
        out)."""
        batch = self.pack_batch(requests)
        args = batch.kernel_args(self.device)
        info = None
        if spans.on() and args["pages"].is_cuda:
            info = lane_info_buffer(len(batch.pages), args["pages"].device)
            args["lane_info"] = info
        raw = lane_replay(**args)
        raw_steps = None
        with spans.span("cuda_backend.readback"):
            if batch.steps_len:
                raw, raw_steps = raw
                raw_steps = raw_steps.cpu().numpy()
            raw = raw.cpu().numpy()
            if info is not None:
                info = info[:len(requests)].cpu().numpy()
        if info is not None:
            count_lane_info(requests, info, raw[:len(requests)])
        return self._unpack(requests, raw, raw_steps)

    @spans.spanned("cuda_backend.unpack")
    def _unpack(self, requests: Sequence[ReplayRequest], raw: np.ndarray,
                raw_steps: Optional[np.ndarray]) -> List[UVMStats]:
        """K1's stats (and window clocks) -> one ``UVMStats`` a lane."""
        out = []
        for lane, req in enumerate(requests):
            row = raw[lane]
            stats = UVMStats(
                name=req.trace.name, prefetcher=req.prefetcher.name,
                n_accesses=len(req.trace.pages),
                n_instructions=req.trace.n_instructions,
                cycles=float(row[0]), hits=int(row[1]), late=int(row[2]),
                faults=int(row[3]), prefetch_issued=int(row[4]),
                prefetch_used=int(row[5]), pages_migrated=int(row[6]),
                pages_evicted=int(row[7]), pcie_bytes=float(row[8]),
                zero_copy_bytes=0.0, timeline=None,
                eviction=req.config.eviction)
            stats.backend = self.name
            tenancy = resolve_tenancy(req.trace, req.config)
            if tenancy is not None:
                th0 = int(row[len(STAT_FIELDS)])
                stats.tenant_hits = (th0, stats.hits - th0)
                stats.tenant_accesses = _tenant_accesses(req.trace.pages,
                                                         tenancy)
            if req.step_bounds is not None:
                stats.step_clocks = _fill_step_clocks(
                    np.asarray(req.step_bounds, dtype=np.int64),
                    raw_steps[lane])
            out.append(stats)
        return out


def _fill_step_clocks(bounds: np.ndarray, lane_steps: np.ndarray
                     ) -> np.ndarray:
    """K1's per-window clocks -> ``UVMStats.step_clocks``.  K1 writes only
    the windows that own an access, so an empty window (a repeated bound)
    takes the clock of the window before it, and leading empty windows end
    at clock 0.0: the legacy engine's recording semantics."""
    n_steps = bounds.size
    vals = np.asarray(lane_steps[:n_steps], dtype=np.float64)
    sizes = np.diff(np.concatenate([[0], bounds]))
    idx = np.where(sizes > 0, np.arange(n_steps), -1)
    idx = np.maximum.accumulate(idx)
    return np.where(idx >= 0, vals[np.maximum(idx, 0)], 0.0)
