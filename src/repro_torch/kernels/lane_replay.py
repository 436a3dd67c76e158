"""K1: multi-lane UVM replay -- wrapper of ``csrc/lane_replay.cu``.

Replaces the reference's Pallas kernel
``repro.uvm.backends.pallas_backend._lane_replay_fn``: every lane family
(``demand``, ``tree``, ``learned``, ``oracle``) under the three eviction
policies (``lru``, ``random``, ``hotcold``), with the kernel's two optional
branches, step-clock capture and two-tenant tenancy (shared capacity, or
hard per-tenant quotas with a spill pool).  The host side (lane packing,
parameter blocks, stats unpacking) is
``repro_torch.uvm.backends.cuda_backend``.

Inputs per lane (one row each): ``pages`` (L, T) int32 page ids relative to
the lane's span; ``preds`` (L, T) int32 learned decision stream (-1 = no
prediction) for learned lanes; ``ft`` (L, F) int32 first-touch page stream
padded with the trash slot ``span`` and ``pos`` (L, T) int32 stream position
per access for oracle lanes; ``sids`` (L, T) int32 step-window id per access
for step-clock lanes; ``fparams`` (L, 8) float64 and ``iparams`` (L, 9)
int32 in the reference's layout (``iparams[:, 6:9]``: the dense tenant
boundary and the quotas q0, q1, q0 = -1 for shared capacity).  Output:
(L, 10) float64, ``STAT_FIELDS`` then the tenant-0 hit count, and for
step-clock batches the (L, steps_len) float64 window clocks.

The kernel finds each victim over per-lane bounds of its chunks of
``ROOT_PAGES`` slots, and takes the rest of a long burst, after its first
``K1_ROUND_MIN`` victims, in one block-wide selection round (see
``csrc/lane_replay.cu``); the plain version's ``argmin`` over the span, one
victim at a time, is the spec it is held to.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.uvm.eviction import eviction_score

N_FPARAMS = 8
N_IPARAMS = 9
STAT_FIELDS = ("cycles", "hits", "late", "faults", "prefetch_issued",
               "prefetch_used", "pages_migrated", "pages_evicted",
               "pcie_bytes")
N_STATS = len(STAT_FIELDS) + 1          # + hits_t0
BLK_PAGES = 16
ROOT_PAGES = 512
TREE_LEVELS = 5                         # TreePrefetcher.LEVELS
ORACLE_MAX_EXTRAS = 16
#: kernel ids of the lane families and eviction policies (csrc order)
FAMILIES = ("demand", "tree", "learned", "oracle")
POLICIES = ("lru", "random", "hotcold")
#: one thread per oracle window entry
MAX_ORACLE_LOOKAHEAD = 512
#: per-lane step-clock window ceiling: the window clocks are steps_len + 1
#: float64 per lane
MAX_LANE_STEPS = 1 << 16
#: the random victim key is (prio << 21) | slot: every state slot (span +
#: the oracle trash slot) must fit the low 21 bits
RANDOM_KEY_SLOTS = 1 << 21
#: the columns of K1's optional ``lane_info`` output, one row a lane:
#: warp-search chunk scans, nanoseconds on the card's global timer,
#: selection rounds, and the evictions those rounds made
LANE_INFO_FIELDS = ("scans", "ns", "rounds", "round_evictions")
_IMAX = 2 ** 31 - 1
_IMAX64 = 2 ** 63 - 1
_INF = math.inf


def _replay_lane_plain(pages, preds, ft, pos, sids, fp, ip, span: int,
                       family: str, policy: str, lookahead: int,
                       steps_len: int, quotas: bool):
    """One lane's replay: the kernel's operation order, as a per-access
    loop.  The span arrays are tensors; the scalar carries are Python floats
    and ints (IEEE float64, no FMA), so the clock chain rounds as the
    kernel's does.  Returns the stats row and, with ``steps_len``, the
    lane's window clocks."""
    cpa, page_tx, ff, ptw, pcie_lat, pfo, extra_lat, page_size = fp
    n, cap, mshr, has_block = ip[0], ip[1], ip[2], ip[3] > 0
    n_ft, lane_lo, bnd = ip[4], ip[5] & 0xFFFFFFFF, ip[6]
    # per-tenant quotas (q0 < 0: shared capacity); rc0 counts the resident
    # pages of tenant 0 (slots below the dense boundary)
    q0, q1 = ip[7], ip[8]
    split = quotas and q0 >= 0
    rc0 = 0
    # window clocks: slot steps_len is the trash slot of accesses past the
    # last bound
    steps = [0.0] * (steps_len + 1)
    tree, oracle = family == "tree", family == "oracle"
    randomp, hotcold = policy == "random", policy == "hotcold"
    # oracle lanes get a trash slot at ``span``: padded first-touch entries
    # point there; it reads resident and is never a victim
    state_len = span + 1 if oracle else span
    arrival = torch.full((state_len,), _INF, dtype=torch.float64)
    stamp = torch.zeros(state_len, dtype=torch.int64)
    pfu = torch.zeros(state_len, dtype=torch.bool)
    freq = torch.zeros(state_len, dtype=torch.int64)     # hotcold
    prio = torch.zeros(state_len, dtype=torch.int64)     # random (uint32)
    iota = torch.arange(span, dtype=torch.int64)
    # tree: resident pages per node (node span BLK_PAGES << lv), level lv
    # at lv_off[lv] of one flat array, as the kernel lays them out
    lv_off = [sum(span >> (4 + k) for k in range(lv))
              for lv in range(TREE_LEVELS + 2)]
    counts = torch.zeros(lv_off[-1] if tree else 0, dtype=torch.int64)

    def nodes(q: int):
        return [lv_off[lv] + (q >> (4 + lv)) for lv in range(TREE_LEVELS + 1)]
    if oracle:
        arrival[span] = 0.0
        stamp[span] = _IMAX
    buf = []                              # outstanding stall points
    clock = pcie_free = next_free = 0.0
    counter = resident = hits = late = faults = 0
    issued = used = migrated = evicted = wbacks = th0 = 0

    def insert(idx: torch.Tensor, arr, first: int) -> None:
        """Extras ``idx`` (in emission order) become resident at ``arr``,
        stamped ``first``, ``first + 1``, ...; policy state at insert."""
        nonlocal rc0
        rc0 += int((idx < bnd).sum())
        ranks = torch.arange(first, first + len(idx), dtype=torch.int64)
        arrival[idx] = arr
        pfu[idx] = True
        stamp[idx] = ranks
        freq[idx] = 0
        if randomp:
            prio[idx] = torch.tensor(
                [eviction_score(lane_lo + q, d)
                 for q, d in zip(idx.tolist(), ranks.tolist())],
                dtype=torch.int64)

    def batch_end(k: int):
        """(start, end) of a k-page prefetch DMA queued behind the bus."""
        ex_ready = clock + pfo + extra_lat
        ex_start = max(pcie_free, ex_ready)
        return ex_start, ex_start + float(k) * page_tx

    offs = torch.arange(ROOT_PAGES, dtype=torch.int64)
    look_iota = torch.arange(lookahead, dtype=torch.int64)
    for t in range(n):
        p = pages[t]
        clock = clock + cpa
        a = float(arrival[p])
        is_hit = a <= clock
        is_late = a < _INF and not is_hit
        is_fault = a == _INF
        hits += is_hit
        late += is_late
        faults += is_fault
        th0 += is_hit and p < bnd
        if pfu[p]:
            used += 1
            pfu[p] = False
        arr_v = 0.0
        if is_fault:
            mod = math.fmod(clock, ff)
            div = (clock - mod) / ff
            fd = float(math.floor(div))
            if div - fd > 0.5:
                fd = fd + 1.0
            ready = (fd + 2.0) * ff + ptw
            start = max(ready, pcie_free)
            arr_v = start + pcie_lat + page_tx
            arrival[p] = arr_v
            freq[p] = 0
            if randomp:
                prio[p] = eviction_score(lane_lo + p, counter)
            resident += 1
            rc0 += p < bnd
            migrated += 1
            pcie_free = start + page_tx
        elif hotcold:
            freq[p] += 1
        stamp[p] = counter
        counter += 1
        if is_fault or is_late:
            buf.append(arr_v if is_fault else a)
        if tree and is_fault:
            # on_migrate([demand]) runs before on_fault
            counts[nodes(p)] += 1

        if family in ("demand", "learned") and is_fault and has_block:
            blk = (p // BLK_PAGES) * BLK_PAGES
            idx = blk + torch.nonzero(
                arrival[blk:blk + BLK_PAGES] == _INF).flatten()
            k = len(idx)
            if k:
                _, end = batch_end(k)
                insert(idx, end + pcie_lat, counter)
                counter += k
                resident += k
                migrated += k
                issued += k
                pcie_free = end

        if tree and is_fault:
            # classify the 2 MB root window, then the >50% escalation walk;
            # extras per level in ascending page order (the emission order)
            root = (p // ROOT_PAGES) * ROOT_PAGES
            rel = p - root
            nonres = arrival[root:root + ROOT_PAGES] == _INF
            out = ((offs >> 4) == (rel >> 4)) & nonres
            pend = out.clone()
            pend[rel] = True
            order = [torch.nonzero(out).flatten()]
            for lv in range(1, TREE_LEVELS + 1):
                sh = 4 + lv
                in_node = (offs >> sh) == (rel >> sh)
                cnt = (int(counts[lv_off[lv] + (root >> sh) + (rel >> sh)])
                       + int((in_node & pend).sum()))
                if cnt * 2 <= BLK_PAGES << lv:
                    break
                ex = in_node & nonres & ~pend
                order.append(torch.nonzero(ex).flatten())
                pend |= ex
            idx = root + torch.cat(order)
            k = len(idx)
            if k:
                _, end = batch_end(k)
                insert(idx, end + pcie_lat, counter)
                counter += k
                resident += k
                migrated += k
                issued += k
                pcie_free = end
                for lv in range(TREE_LEVELS + 1):
                    counts.index_add_(0, lv_off[lv] + (idx >> (4 + lv)),
                                      torch.ones_like(idx))

        if family == "learned" and clock >= next_free:
            # serialized inference server: the access consumes the gate; a
            # valid, non-demand, non-resident top-1 prediction migrates
            next_free = clock + extra_lat
            pred = preds[t]
            if pred >= 0 and pred != p and float(arrival[pred]) == _INF:
                _, end = batch_end(1)
                insert(torch.tensor([pred]), end + pcie_lat, counter)
                counter += 1
                resident += 1
                migrated += 1
                issued += 1
                pcie_free = end

        if oracle:
            # a lookahead window of the first-touch stream, up to 16
            # non-resident pages in stream order; a fault scans twice (batch
            # DMA, then continuous with the sequential arrival chain)
            p_t = pos[t]
            win = ft[p_t:p_t + lookahead]
            valid = (p_t + look_iota) < n_ft
            for batch in ((True, False) if is_fault else (False,)):
                take = valid & (arrival[win] == _INF)
                idx = win[take][:ORACLE_MAX_EXTRAS]
                k = len(idx)
                if not k:
                    continue
                ex_start, end = batch_end(k)
                if batch:
                    arr = end + pcie_lat
                else:
                    arr, tv = [], ex_start
                    for _ in range(k):
                        tv = tv + page_tx
                        arr.append(tv + pcie_lat)
                    arr = torch.tensor(arr, dtype=torch.float64)
                insert(idx, arr, counter)
                counter += k
                resident += k
                migrated += k
                issued += k
                pcie_free = end

        if len(buf) > mshr:
            oldest = min(buf)
            buf.remove(oldest)
            clock = max(clock, oldest)
        if steps_len:
            # the clock is final for this access: eviction never moves it
            steps[sids[t]] = clock
        while cap >= 0:
            # the real slots only: never the oracle trash slot
            res = arrival[:span] < _INF
            if split:
                # trim whichever tenant is over its allowance (quota plus
                # the spill the co-tenant does not borrow), tenant 0 first;
                # the victim is masked to that tenant's slots
                rc1 = resident - rc0
                spill = cap - q0 - q1
                over0 = rc0 > q0 + max(0, spill - max(0, rc1 - q1))
                over1 = rc1 > q1 + max(0, spill - max(0, rc0 - q0))
                if not (over0 or over1):
                    break
                res = res & ((iota < bnd) if over0 else (iota >= bnd))
            elif resident <= cap:
                break
            if randomp:
                key = torch.where(res, (prio[:span] << 21) | iota, _IMAX64)
            elif hotcold:
                key = torch.where(res, (freq[:span] << 32) | stamp[:span],
                                  _IMAX64)
            else:
                key = torch.where(res, stamp[:span], _IMAX)
            vi = int(torch.argmin(key))
            v_arr = float(arrival[vi])
            if v_arr > clock:
                # in flight: retouched at MRU, the round stops
                stamp[vi] = counter
                freq[vi] += 1
                counter += 1
                break
            arrival[vi] = _INF
            pfu[vi] = False
            resident -= 1
            rc0 -= vi < bnd
            evicted += 1
            if tree:
                counts[nodes(vi)] -= 1
            if evicted % 2 == 0:
                wbacks += 1
                pcie_free = pcie_free + page_tx
    if buf:
        clock = max(clock, max(buf))
    return ([clock, hits, late, faults, issued, used, migrated, evicted,
             (migrated + wbacks) * page_size, th0], steps[:steps_len])


def _check_kind(family: str, policy: str, span: int, lookahead: int,
                steps_len: int) -> None:
    if family not in FAMILIES or policy not in POLICIES:
        raise ValueError(f"lane_replay: unknown family {family!r} or "
                         f"policy {policy!r}")
    if not 0 <= steps_len <= MAX_LANE_STEPS:
        raise ValueError(f"lane_replay: {steps_len} step windows outside "
                         f"0..{MAX_LANE_STEPS}")
    # a block DMA reads the faulting page's whole 64 KB block, a tree fault
    # its whole 2 MB root window: both must lie inside the span
    whole = ROOT_PAGES if family == "tree" else BLK_PAGES
    if span % whole:
        raise ValueError(f"lane_replay: {family} lanes need a span that is a "
                         f"multiple of {whole}, got {span}")
    if policy == "random" and span + 1 > RANDOM_KEY_SLOTS:
        raise ValueError(
            f"lane_replay: span {span} overflows the random-policy victim "
            f"key (prio << 21 | slot needs span + 1 <= {RANDOM_KEY_SLOTS})")
    if family == "oracle" and not 0 < lookahead <= MAX_ORACLE_LOOKAHEAD:
        raise ValueError(f"lane_replay: oracle lookahead {lookahead} outside "
                         f"1..{MAX_ORACLE_LOOKAHEAD}")


def lane_replay_plain(pages: torch.Tensor, preds: Optional[torch.Tensor],
                      fparams: torch.Tensor, iparams: torch.Tensor,
                      span: int, *, family: str, policy: str = "lru",
                      ft: Optional[torch.Tensor] = None,
                      pos: Optional[torch.Tensor] = None,
                      lookahead: int = 0,
                      sids: Optional[torch.Tensor] = None,
                      steps_len: int = 0, quotas: bool = False):
    """The plain PyTorch version of :func:`lane_replay`, lane by lane."""
    _check_kind(family, policy, span, lookahead, steps_len)
    rows, steps = [], []
    for lane in range(pages.shape[0]):
        ip = [int(x) for x in iparams[lane].tolist()]
        n = ip[0]
        row, lane_steps = _replay_lane_plain(
            pages[lane, :n].tolist(),
            preds[lane, :n].tolist() if family == "learned" else None,
            ft[lane].long() if family == "oracle" else None,
            pos[lane, :n].tolist() if family == "oracle" else None,
            sids[lane, :n].tolist() if steps_len else None,
            [float(x) for x in fparams[lane].tolist()], ip, span, family,
            policy, lookahead, steps_len, quotas)
        rows.append(row)
        steps.append(lane_steps)
    out = torch.tensor(rows, dtype=torch.float64).reshape(-1, N_STATS)
    if not steps_len:
        return out
    return out, torch.tensor(steps, dtype=torch.float64).reshape(
        -1, steps_len)


def lane_replay(pages: torch.Tensor, preds: Optional[torch.Tensor],
                fparams: torch.Tensor, iparams: torch.Tensor, span: int,
                buf_len: int, *, family: str, policy: str = "lru",
                ft: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                lookahead: int = 0, sids: Optional[torch.Tensor] = None,
                steps_len: int = 0, quotas: bool = False,
                lane_info: Optional[torch.Tensor] = None):
    """Replay every lane; returns (L, 10) float64 stats, and with
    ``steps_len > 0`` also the (L, steps_len) float64 window clocks.
    Launches K1 for CUDA tensors (counted in ``lane_replay.launches``, and
    per kind in ``lane_replay.launches_by``); CPU tensors take the plain
    version.  ``span`` is the dense state length of every lane, ``buf_len``
    the MSHR buffer length (largest ``mshr`` + 1); ``family`` is one of
    ``FAMILIES`` (``preds`` only for learned lanes); oracle lanes pass
    ``ft``, ``pos`` and their ``lookahead``.  Step-clock lanes pass
    ``sids``, the window id of every access (``steps_len`` = past the last
    bound), and ``steps_len``; ``quotas`` builds the per-tenant quota
    eviction for the lanes whose ``iparams[:, 7]`` (q0) is >= 0, whose
    tenant boundary must lie on a chunk edge (a multiple of ``ROOT_PAGES``).
    ``lane_info``, an (L, 4) int64 tensor on the card, receives each lane's
    ``LANE_INFO_FIELDS``: its warp-search chunk scans, its nanoseconds on
    the card's global timer, its selection rounds and their evictions (the
    kernel only: the plain version has neither chunks nor rounds)."""
    _check_kind(family, policy, span, lookahead, steps_len)
    if pages.device.type == "cpu":
        if lane_info is not None:
            raise ValueError("lane_replay: lane_info is the kernel's; the "
                             "plain version has no chunks")
        return lane_replay_plain(pages, preds, fparams, iparams, span,
                                 family=family, policy=policy, ft=ft,
                                 pos=pos, lookahead=lookahead, sids=sids,
                                 steps_len=steps_len, quotas=quotas)
    n_lanes, t_max = pages.shape
    expect = [("pages", pages, torch.int32, (n_lanes, t_max)),
              ("fparams", fparams, torch.float64, (n_lanes, N_FPARAMS)),
              ("iparams", iparams, torch.int32, (n_lanes, N_IPARAMS))]
    if family == "learned":
        expect.append(("preds", preds, torch.int32, (n_lanes, t_max)))
    if family == "oracle":
        expect.append(("pos", pos, torch.int32, (n_lanes, t_max)))
        expect.append(("ft", ft, torch.int32, (n_lanes, None)))
    if steps_len:
        expect.append(("sids", sids, torch.int32, (n_lanes, t_max)))
    for name, t, dtype, shape in expect:
        if (t is None or t.device != pages.device or t.dtype != dtype
                or t.dim() != 2 or t.shape[0] != n_lanes
                or shape[1] not in (None, t.shape[1])
                or not t.is_contiguous()):
            raise ValueError(
                f"lane_replay: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {pages.device}, got "
                + ("None" if t is None else
                   f"{t.dtype} {tuple(t.shape)} on {t.device}"))
    if not (ROOT_PAGES <= span <= 1 << 21) or buf_len < 1:
        raise ValueError(f"lane_replay: bad span {span} / buf_len {buf_len}")
    if lane_info is not None and (
            lane_info.device != pages.device or lane_info.dtype != torch.int64
            or tuple(lane_info.shape) != (n_lanes, len(LANE_INFO_FIELDS))
            or not lane_info.is_contiguous()):
        raise ValueError(f"lane_replay: lane_info must be a contiguous int64 "
                         f"tensor of shape ({n_lanes}, "
                         f"{len(LANE_INFO_FIELDS)}) on {pages.device}")
    if quotas:
        check_quota_boundaries(iparams.cpu())
    ft_len = ft.shape[1] if family == "oracle" else 0
    lib = build.load("lane_replay")
    fn = lib.lane_replay_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    dev = pages.device
    state_len = span + 1 if family == "oracle" else span
    arrival = torch.empty((n_lanes, state_len), dtype=torch.float64,
                          device=dev)
    stamp = torch.empty((n_lanes, state_len), dtype=torch.int32, device=dev)
    pfu = torch.empty((n_lanes, state_len), dtype=torch.uint8, device=dev)
    freq = prio = counts = None
    if policy == "hotcold":
        freq = torch.empty((n_lanes, state_len), dtype=torch.int32,
                           device=dev)
    if policy == "random":
        prio = torch.empty((n_lanes, state_len), dtype=torch.int32,
                           device=dev)
    if family == "tree":
        n_nodes = sum(span >> (4 + lv) for lv in range(TREE_LEVELS + 1))
        counts = torch.empty((n_lanes, n_nodes), dtype=torch.int32,
                             device=dev)
    buf = torch.empty((n_lanes, buf_len), dtype=torch.float64, device=dev)
    out = torch.empty((n_lanes, N_STATS), dtype=torch.float64, device=dev)
    # window clocks: steps_len + 1 per lane, the last one the trash slot
    steps = (torch.empty((n_lanes, steps_len + 1), dtype=torch.float64,
                         device=dev) if steps_len else None)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ptr(pages), ptr(preds if family == "learned" else None),
             ptr(ft if family == "oracle" else None),
             ptr(pos if family == "oracle" else None),
             ptr(sids if steps_len else None), ptr(fparams),
             ptr(iparams), ptr(arrival), ptr(stamp), ptr(pfu), ptr(freq),
             ptr(prio), ptr(counts), ptr(buf), ptr(out), ptr(steps),
             ptr(lane_info), n_lanes, t_max, span, buf_len,
             FAMILIES.index(family), POLICIES.index(policy), ft_len,
             lookahead, steps_len, int(quotas), stream)
    build.check(lib, err, "lane_replay")
    lane_replay.launches += 1
    key = kind_key(family, policy, steps_len, quotas)
    lane_replay.launches_by[key] = lane_replay.launches_by.get(key, 0) + 1
    return out if not steps_len else (out, steps[:, :steps_len])


def check_quota_boundaries(iparams: torch.Tensor) -> None:
    """Raise unless every quota lane's tenant boundary (``iparams[:, 6]``
    where q0 = ``iparams[:, 7]`` >= 0) lies on a chunk edge, so that each
    tenant's slots are whole chunks of the kernel's victim search."""
    bnd, q0 = iparams[:, 6].long(), iparams[:, 7]
    bad = (q0 >= 0) & (bnd > 0) & (bnd % ROOT_PAGES != 0)
    if bool(bad.any()):
        raise ValueError(
            f"lane_replay: quota lanes {bad.nonzero().flatten().tolist()} "
            f"have tenant boundaries {bnd[bad].tolist()} off the "
            f"{ROOT_PAGES}-slot chunk edges")


def kind_key(family: str, policy: str, steps_len: int = 0,
             quotas: bool = False) -> Tuple[str, ...]:
    """The launch-count key of one K1 variant: (family, policy), plus
    ``"steps"`` for step-clock batches and ``"quotas"`` for quota
    batches."""
    return ((family, policy) + (("steps",) if steps_len else ())
            + (("quotas",) if quotas else ()))


def reset_counts() -> None:
    """Zero K1's launch counters."""
    lane_replay.launches = 0
    lane_replay.launches_by = {}


lane_replay.launches = 0
lane_replay.launches_by = {}
