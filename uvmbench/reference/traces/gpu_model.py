"""GPU execution model: CTA dispatch, per-SM interleaving, TLB filtering, and
GMMU stream merge.

This stands in for GPGPU-Sim as the paper's trace source.  It models the two
properties the paper's insights depend on:

1.  Per-SM access streams are near-program-order (a CTA runs to completion on
    one SM, fine-grained multithreading interleaves the resident CTAs), while
    the *merged* GMMU stream interleaves 28 SMs — which destroys PC-sequence
    order.  This is exactly why SM-id clustering wins the paper's Table 2.
2.  Hot, small arrays (the `x` vector of ATAX, DP buffers, ...) are absorbed
    by the SM's TLB and rarely reach the GMMU, so the GMMU trace of the
    streaming Polybench kernels is dominated by one large address delta
    (paper §5.3: 99.26 % convergence for ATAX).

The merge uses per-access virtual timestamps (exponential gaps with per-SM
rate jitter) so scheduling noise is reproducible under a seed.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List

import numpy as np

from uvmbench.reference.traces.generators import BenchmarkSpec, CTAStream
from uvmbench.reference.traces.trace import ACCESS_DTYPE, Trace


@dataclasses.dataclass
class GPUModelConfig:
    """Paper Table 9: GTX 1080 Ti (Pascal), 28 SMs, 64 warps / 32 CTAs max."""

    n_sms: int = 28
    max_cta_per_sm: int = 16
    warps_per_cta: int = 8
    tlb_window: int = 1024     # per-SM TLB reuse window (accesses)
    sm_rate_sigma: float = 0.35  # log-normal jitter of per-SM progress rates
    burst_len: float = 24.0    # mean GMMU-request burst length per CTA; a
    # warp that faulted on a page computes on it for a while, so page-level
    # requests from one CTA arrive in runs before the scheduler switches.
    seed: int = 0


class GPUModel:
    """Schedules BenchmarkSpec CTA streams onto SMs and emits the GMMU trace."""

    def __init__(self, config: GPUModelConfig | None = None) -> None:
        self.config = config or GPUModelConfig()

    # ------------------------------------------------------------------
    def run(self, spec: BenchmarkSpec) -> Trace:
        cfg = self.config
        # crc32, not hash(): str hashing is salted per process, which would
        # make traces (and every downstream golden fixture) irreproducible
        rng = np.random.default_rng(
            cfg.seed ^ (zlib.crc32(spec.name.encode()) & 0xFFFF))
        kernels = sorted({s.kernel for s in spec.streams})
        per_kernel: Dict[int, List[CTAStream]] = {k: [] for k in kernels}
        for s in spec.streams:
            per_kernel[s.kernel].append(s)

        out_chunks: List[np.ndarray] = []
        t_base = 0.0
        for k in kernels:
            chunk, t_base = self._run_kernel(per_kernel[k], rng, t_base)
            out_chunks.append(chunk)
        accesses = np.concatenate(out_chunks) if out_chunks else np.empty(0, ACCESS_DTYPE)
        return Trace(
            name=spec.name,
            accesses=accesses,
            array_bases=dict(spec.array_bases),
            array_pages=dict(spec.array_pages),
            n_instructions=spec.n_instructions,
            meta={"generated_accesses": float(spec.total_accesses)},
        )

    # ------------------------------------------------------------------
    def _run_kernel(self, streams: List[CTAStream], rng: np.random.Generator,
                    t_base: float):
        cfg = self.config
        # Round-robin CTA dispatch over SMs, in waves of max_cta_per_sm.
        streams = sorted(streams, key=lambda s: s.cta)
        sm_events: List[np.ndarray] = []
        sm_times: List[np.ndarray] = []
        slot_capacity = cfg.n_sms * cfg.max_cta_per_sm
        for sm in range(cfg.n_sms):
            mine = streams[sm::cfg.n_sms]
            if not mine:
                continue
            recs, times = self._sm_schedule(sm, mine, rng, slot_capacity, t_base)
            recs, times = self._tlb_filter(recs, times)
            sm_events.append(recs)
            sm_times.append(times)
        if not sm_events:
            return np.empty(0, ACCESS_DTYPE), t_base
        all_recs = np.concatenate(sm_events)
        all_times = np.concatenate(sm_times)
        order = np.argsort(all_times, kind="stable")
        t_end = float(all_times.max()) if all_times.size else t_base
        return all_recs[order], t_end

    def _sm_schedule(self, sm: int, mine: List[CTAStream],
                     rng: np.random.Generator, slot_capacity: int,
                     t_base: float):
        """Interleave the CTAs resident on one SM; later waves start after
        earlier ones retire.

        The schedule is *deterministic round-robin over bursts* with small
        timing jitter — GPGPU-Sim's GTO warp scheduler is deterministic, and
        that determinism is what makes per-SM access patterns learnable
        (the paper's premise).  A CTA issues ``burst`` page requests, then
        the scheduler rotates to the next resident CTA.
        """
        cfg = self.config
        n_total = sum(len(s.pages) for s in mine)
        recs = np.zeros(n_total, dtype=ACCESS_DTYPE)
        times = np.empty(n_total, dtype=np.float64)
        pos = 0
        # per-SM progress rate (stragglers / fast SMs)
        rate = float(np.exp(rng.normal(0.0, cfg.sm_rate_sigma)))
        wave_len = cfg.max_cta_per_sm
        wave_t = t_base
        for w0 in range(0, len(mine), wave_len):
            wave = mine[w0:w0 + wave_len]
            wave_end = wave_t
            n_resident = len(wave)
            for slot, s in enumerate(wave):
                n = len(s.pages)
                burst_len = max(int(s.burst), 1)
                idx = np.arange(n)
                burst_id = idx // burst_len
                within = idx % burst_len
                # round-robin: burst b of slot k starts after every resident
                # CTA finished its burst b-1
                ts = (wave_t
                      + burst_id * (burst_len * n_resident) / rate
                      + slot * burst_len / rate
                      + within / rate
                      + rng.normal(0.0, 0.05, size=n))
                sl = slice(pos, pos + n)
                recs["pc"][sl] = s.pcs
                recs["sm"][sl] = sm
                recs["tpc"][sl] = sm // 2
                recs["cta"][sl] = s.cta
                # hardware warp *slot* within the SM (64 slots, reused as
                # CTAs retire) — the id GPGPU-Sim exposes to the GMMU
                warp_base = (s.cta * cfg.warps_per_cta) % 64
                recs["warp"][sl] = (warp_base + (np.arange(n) % cfg.warps_per_cta)) % 64
                recs["kernel"][sl] = s.kernel
                recs["array"][sl] = s.arrays
                recs["page"][sl] = s.pages
                times[sl] = ts
                wave_end = max(wave_end, float(ts[-1]) if n else wave_t)
                pos += n
            wave_t = wave_end
        return recs[:pos], times[:pos]

    def _tlb_filter(self, recs: np.ndarray, times: np.ndarray):
        """Drop accesses whose page was touched by this SM within the last
        `tlb_window` accesses (they hit the SM-side TLB and never reach the
        GMMU).  Window-based approximation of an LRU TLB."""
        w = self.config.tlb_window
        if w <= 0 or recs.size == 0:
            return recs, times
        last_seen: Dict[int, int] = {}
        keep = np.ones(recs.size, dtype=bool)
        pages = recs["page"]
        for i in range(pages.size):
            p = int(pages[i])
            j = last_seen.get(p)
            if j is not None and i - j <= w:
                keep[i] = False
            last_seen[p] = i
        return recs[keep], times[keep]
