"""K1: multi-lane UVM replay -- wrapper of ``csrc/lane_replay.cu``.

Replaces the reference's Pallas kernel
``repro.uvm.backends.pallas_backend._lane_replay_fn`` for the demand and
learned lane families under LRU eviction with shared-capacity tenancy.  The
host side (lane packing, parameter blocks, stats unpacking) is
``repro_torch.uvm.backends.cuda_backend``.

Inputs per lane (one row each): ``pages`` (L, T) int32 page ids relative to
the lane's span; ``preds`` (L, T) int32 learned decision stream (-1 = no
prediction), or None for demand lanes; ``fparams`` (L, 8) float64 and
``iparams`` (L, 9) int32 in the reference's layout.  Output: (L, 10) float64,
``STAT_FIELDS`` then the tenant-0 hit count.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

N_FPARAMS = 8
N_IPARAMS = 9
STAT_FIELDS = ("cycles", "hits", "late", "faults", "prefetch_issued",
               "prefetch_used", "pages_migrated", "pages_evicted",
               "pcie_bytes")
N_STATS = len(STAT_FIELDS) + 1          # + hits_t0
BLK_PAGES = 16
_IMAX = 2 ** 31 - 1
_INF = math.inf


def _replay_lane_plain(pages, preds, fp, ip, span: int):
    """One lane's replay: the kernel's operation order, as a per-access
    loop.  The span arrays are tensors; the scalar carries are Python floats
    and ints (IEEE float64, no FMA), so the clock chain rounds as the
    kernel's does."""
    cpa, page_tx, ff, ptw, pcie_lat, pfo, extra_lat, page_size = fp
    n, cap, mshr, has_block = ip[0], ip[1], ip[2], ip[3] > 0
    bnd = ip[6]
    arrival = torch.full((span,), _INF, dtype=torch.float64)
    stamp = torch.zeros(span, dtype=torch.int32)
    pfu = torch.zeros(span, dtype=torch.bool)
    buf = []                              # outstanding stall points
    clock = pcie_free = next_free = 0.0
    counter = resident = hits = late = faults = 0
    issued = used = migrated = evicted = wbacks = th0 = 0
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
            resident += 1
            migrated += 1
            pcie_free = start + page_tx
        stamp[p] = counter
        counter += 1
        if is_fault or is_late:
            buf.append(arr_v if is_fault else a)
        if is_fault and has_block:
            blk = (p // BLK_PAGES) * BLK_PAGES
            mask = arrival[blk:blk + BLK_PAGES] == _INF
            k = int(mask.sum())
            if k:
                ex_ready = clock + pfo + extra_lat
                ex_start = max(pcie_free, ex_ready)
                end = ex_start + float(k) * page_tx
                arrival[blk:blk + BLK_PAGES][mask] = end + pcie_lat
                pfu[blk:blk + BLK_PAGES][mask] = True
                stamp[blk:blk + BLK_PAGES][mask] = torch.arange(
                    counter, counter + k, dtype=torch.int32)
                counter += k
                resident += k
                migrated += k
                issued += k
                pcie_free = end
        if preds is not None and clock >= next_free:
            next_free = clock + extra_lat
            pred = preds[t]
            if pred >= 0 and pred != p and float(arrival[pred]) == _INF:
                ex_ready = clock + pfo + extra_lat
                ex_start = max(pcie_free, ex_ready)
                end = ex_start + page_tx
                arrival[pred] = end + pcie_lat
                stamp[pred] = counter
                pfu[pred] = True
                counter += 1
                resident += 1
                migrated += 1
                issued += 1
                pcie_free = end
        if len(buf) > mshr:
            oldest = min(buf)
            buf.remove(oldest)
            clock = max(clock, oldest)
        while cap >= 0 and resident > cap:
            vi = int(torch.argmin(torch.where(arrival < _INF, stamp, _IMAX)))
            v_arr = float(arrival[vi])
            if v_arr > clock:
                stamp[vi] = counter
                counter += 1
                break
            arrival[vi] = _INF
            pfu[vi] = False
            resident -= 1
            evicted += 1
            if evicted % 2 == 0:
                wbacks += 1
                pcie_free = pcie_free + page_tx
    if buf:
        clock = max(clock, max(buf))
    return [clock, hits, late, faults, issued, used, migrated, evicted,
            (migrated + wbacks) * page_size, th0]


def lane_replay_plain(pages: torch.Tensor, preds: Optional[torch.Tensor],
                      fparams: torch.Tensor, iparams: torch.Tensor,
                      span: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`lane_replay`, lane by lane."""
    rows = []
    for lane in range(pages.shape[0]):
        ip = [int(x) for x in iparams[lane].tolist()]
        rows.append(_replay_lane_plain(
            pages[lane, :ip[0]].tolist(),
            None if preds is None else preds[lane, :ip[0]].tolist(),
            [float(x) for x in fparams[lane].tolist()], ip, span))
    return torch.tensor(rows, dtype=torch.float64).reshape(-1, N_STATS)


def lane_replay(pages: torch.Tensor, preds: Optional[torch.Tensor],
                fparams: torch.Tensor, iparams: torch.Tensor, span: int,
                buf_len: int) -> torch.Tensor:
    """Replay every lane; returns (L, 10) float64 stats.  Launches K1 for
    CUDA tensors (counted in ``lane_replay.launches``); CPU tensors take the
    plain version.  ``span`` is the dense state length of every lane and
    ``buf_len`` the MSHR buffer length (largest ``mshr`` + 1)."""
    if pages.device.type == "cpu":
        return lane_replay_plain(pages, preds, fparams, iparams, span)
    n_lanes, t_max = pages.shape
    expect = [("pages", pages, torch.int32, (n_lanes, t_max)),
              ("fparams", fparams, torch.float64, (n_lanes, N_FPARAMS)),
              ("iparams", iparams, torch.int32, (n_lanes, N_IPARAMS))]
    if preds is not None:
        expect.append(("preds", preds, torch.int32, (n_lanes, t_max)))
    for name, t, dtype, shape in expect:
        if (t.device != pages.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"lane_replay: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {pages.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not (0 < span <= 1 << 21) or buf_len < 1:
        raise ValueError(f"lane_replay: bad span {span} / buf_len {buf_len}")
    lib = build.load("lane_replay")
    fn = lib.lane_replay_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    dev = pages.device
    arrival = torch.empty((n_lanes, span), dtype=torch.float64, device=dev)
    stamp = torch.empty((n_lanes, span), dtype=torch.int32, device=dev)
    pfu = torch.empty((n_lanes, span), dtype=torch.uint8, device=dev)
    buf = torch.empty((n_lanes, buf_len), dtype=torch.float64, device=dev)
    out = torch.empty((n_lanes, N_STATS), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(pages.data_ptr(), 0 if preds is None else preds.data_ptr(),
             fparams.data_ptr(), iparams.data_ptr(), arrival.data_ptr(),
             stamp.data_ptr(), pfu.data_ptr(), buf.data_ptr(),
             out.data_ptr(), n_lanes, t_max, span, buf_len,
             int(preds is not None), stream)
    build.check(lib, err, "lane_replay")
    lane_replay.launches += 1
    return out


lane_replay.launches = 0
