"""Declarative oversubscription scenario matrix for the port's sweep.

The port's own copy of the reference ``repro.uvm.scenarios``: the same
:class:`Scenario` dataclass, validation, registry and built-in matrices
under the same names, with the imports rewritten to ``repro_torch``.  Each scenario expands to a (benchmark x oversubscription
ratio x eviction policy x prefetcher) grid of
:class:`~repro_torch.uvm.sweep.SweepCell` cells, every cell stamped with the
scenario name.

Built-ins (see each ``description``): ``oversub-full`` (11 paper benchmarks
x capacity ratios 1.5/1.0/0.75/0.5 x lru/random/hotcold x the five
prefetchers, 660 cells), ``oversub-smoke``, ``serve-full``/``serve-smoke``,
``mt-full``/``mt-smoke``, ``chaos-smoke`` and ``transformer-smoke`` (the
simplified and reference-Transformer families under the ``adaptive``
eviction pseudo-policy, ``repro_torch.uvm.adaptive``).

Usage::

    from repro_torch.uvm.scenarios import expand_scenario
    from repro_torch.uvm.sweep import run_sweep
    rows = run_sweep(expand_scenario("oversub-full"), device="cuda")

or ``python -m repro_torch.uvm.sweep --scenario oversub-full``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.families import MODEL_FAMILIES
from repro_torch.offload.serve_trace import is_serve_bench
from repro_torch.uvm.adaptive import ADAPTIVE_POLICY
from repro_torch.uvm.eviction import EVICTION_POLICIES
from repro_torch.uvm.sweep import PREFETCHERS, SweepCell

#: the paper's full benchmark suite (Table 10) — kept in sync with
#: ``repro_torch.traces.generators.BENCHMARKS`` by :meth:`Scenario.validate`
PAPER_BENCHMARKS = (
    "AddVectors", "ATAX", "Backprop", "BICG", "Hotspot", "MVT", "NW",
    "Pathfinder", "Srad-v2", "StreamTriad", "2DCONV",
)

#: capacity ratios (device memory / working set) of the full matrix:
#: 1.5 = comfortably undersubscribed control, 1.0 = exact fit, 0.75/0.5 =
#: the oversubscription regimes of arXiv 2204.02974
DEFAULT_RATIOS = (1.5, 1.0, 0.75, 0.5)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named (benchmark × ratio × eviction × prefetcher) matrix."""

    name: str
    description: str
    benches: Tuple[str, ...]
    ratios: Tuple[float, ...]                 # device_frac per cell
    evictions: Tuple[str, ...] = EVICTION_POLICIES
    prefetchers: Tuple[str, ...] = PREFETCHERS
    scale: float = 1.0
    window: Optional[float] = 0.6
    seeds: Tuple[int, ...] = (0,)
    prediction_us: float = 1.0
    service_steps: int = 150
    # predictor families for the learned prefetcher cells; non-learned
    # cells still expand per family (the axis is part of the cell key)
    # so keep this ("simplified",) unless the scenario compares families
    model_families: Tuple[str, ...] = ("simplified",)
    # multi-tenant capacity splits ("shared" | "f0/f1" quota fractions of
    # device_pages, see repro_torch.uvm.sweep.parse_capacity_split); quota
    # splits require every bench to be an interleaved pair ("A+B")
    capacity_splits: Tuple[Optional[str], ...] = (None,)

    # ------------------------------------------------------------------
    def validate(self) -> "Scenario":
        """Check every axis against the live registries; returns self."""
        from repro_torch.traces.generators import BENCHMARKS
        from repro_torch.traces.interleave import is_mt_bench
        from repro_torch.uvm.sweep import parse_capacity_split

        if not self.name or "/" in self.name:
            raise ValueError(f"bad scenario name {self.name!r}")
        if not self.benches:
            raise ValueError(f"scenario {self.name!r}: empty benches")
        bad = [b for b in self.benches
               if b not in BENCHMARKS and not is_serve_bench(b)
               and not is_mt_bench(b)]
        if bad:
            raise ValueError(
                f"scenario {self.name!r}: unknown benches {bad}; choose "
                f"from {sorted(BENCHMARKS)}, multi-tenant pairs like "
                "'ATAX+Pathfinder', or serve workloads (see "
                "repro_torch.offload.serve_trace.SERVE_WORKLOADS, rate variants "
                "like 'ServeBursty@r128' accepted)")
        if not self.capacity_splits:
            raise ValueError(
                f"scenario {self.name!r}: empty capacity_splits")
        quota_splits = []
        for split in self.capacity_splits:
            try:
                if parse_capacity_split(split) is not None:
                    quota_splits.append(split)
            except ValueError as e:
                raise ValueError(f"scenario {self.name!r}: {e}") from None
        single = [b for b in self.benches if not is_mt_bench(b)]
        if quota_splits and single:
            raise ValueError(
                f"scenario {self.name!r}: capacity splits {quota_splits} "
                f"need multi-tenant benches, but {single} are "
                "single-tenant")
        serve = [b for b in self.benches if is_serve_bench(b)]
        if serve and self.window is not None:
            raise ValueError(
                f"scenario {self.name!r}: serve benches {serve} must use "
                "window=None (a window split would desynchronize the "
                "decode-step bounds the latency columns derive from)")
        for field, values, vocab in (
                ("evictions", self.evictions,
                 set(EVICTION_POLICIES) | {ADAPTIVE_POLICY}),
                ("prefetchers", self.prefetchers, set(PREFETCHERS)),
                ("model_families", self.model_families,
                 set(MODEL_FAMILIES))):
            if not values:
                raise ValueError(f"scenario {self.name!r}: empty {field}")
            bad = [v for v in values if v not in vocab]
            if bad:
                raise ValueError(
                    f"scenario {self.name!r}: unknown {field} {bad}; "
                    f"choose from {sorted(vocab)}")
        if not self.ratios or any(r <= 0 for r in self.ratios):
            raise ValueError(
                f"scenario {self.name!r}: ratios must be positive, "
                f"got {self.ratios}")
        if self.scale <= 0:
            raise ValueError(f"scenario {self.name!r}: scale must be > 0")
        return self

    # ------------------------------------------------------------------
    def cells(self, *, engine: str = "auto",
              backend: str = "cuda") -> List[SweepCell]:
        """Expand the matrix in deterministic order, each cell stamped
        with the scenario name (the sweep's resume store keys on it)."""
        out = []
        for bench in self.benches:
            for seed in self.seeds:
                for ratio in self.ratios:
                    for eviction in self.evictions:
                        for split in self.capacity_splits:
                            for pf in self.prefetchers:
                                for fam in self.model_families:
                                    out.append(SweepCell(
                                        bench=bench, prefetcher=pf,
                                        scale=self.scale, seed=seed,
                                        window=self.window,
                                        prediction_us=self.prediction_us,
                                        device_frac=ratio,
                                        eviction=eviction,
                                        capacity_split=split,
                                        scenario=self.name, engine=engine,
                                        backend=backend,
                                        service_steps=self.service_steps,
                                        model_family=fam))
        return out

    def n_cells(self) -> int:
        return (len(self.benches) * len(self.seeds) * len(self.ratios)
                * len(self.evictions) * len(self.prefetchers)
                * len(self.model_families) * len(self.capacity_splits))

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def scenario_from_dict(doc: Dict) -> Scenario:
    """JSON round-trip: lists come back as the dataclass's tuples."""
    kwargs = dict(doc)
    for field in ("benches", "ratios", "evictions", "prefetchers", "seeds",
                  "model_families", "capacity_splits"):
        if field in kwargs and kwargs[field] is not None:
            kwargs[field] = tuple(kwargs[field])
    return Scenario(**kwargs).validate()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario, *,
                      replace: bool = False) -> Scenario:
    scenario.validate()
    if scenario.name in _SCENARIOS and not replace:
        raise ValueError(f"scenario {scenario.name!r} already registered "
                         "(pass replace=True to override)")
    _SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {available_scenarios()}") from None


def available_scenarios() -> List[str]:
    return sorted(_SCENARIOS)


def expand_scenario(name: str, *, engine: str = "auto",
                    backend: str = "cuda") -> List[SweepCell]:
    """Expand a registered scenario into sweep cells (the CLI entry:
    ``python -m repro_torch.uvm.sweep --scenario <name>``)."""
    return get_scenario(name).cells(engine=engine, backend=backend)


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

register_scenario(Scenario(
    name="oversub-full",
    description=(
        "Full oversubscription matrix: all 11 paper benchmarks x "
        "capacity ratios (1.5/1.0/0.75/0.5 x working set) x all "
        "eviction policies x all five prefetcher families"),
    benches=PAPER_BENCHMARKS,
    ratios=DEFAULT_RATIOS,
))

#: the serving scenario family: PagedKVStore-derived fault streams
#: replayed as first-class traces — serve
#: scenarios always use window=None so decode-step bounds stay aligned
SERVE_BENCHES = ("ServeDecode", "ServeTenantMix", "ServeBursty")

register_scenario(Scenario(
    name="serve-full",
    description=(
        "Serving-traffic matrix: continuous-batching decode, multi-tenant "
        "mix, and bursty open-loop arrivals (three request rates) x "
        "capacity ratios x all eviction policies x all five prefetcher "
        "families; rows carry p50/p95/p99 decode latency and TTFT"),
    benches=SERVE_BENCHES + ("ServeBursty@r32", "ServeBursty@r256"),
    ratios=DEFAULT_RATIOS,
    window=None,
))

register_scenario(Scenario(
    name="serve-smoke",
    description=(
        "CI smoke for the serving family: 2 serve workloads x 2 "
        "oversubscribed ratios x all eviction policies x the demand-family "
        "prefetchers (none, block) at scale 0.25 — small enough that the "
        "pallas interpret-mode lanes replay every cell, and every row must "
        "record its backend, policy, and latency percentiles "
        "(scripts/ci_check.sh)"),
    benches=("ServeDecode", "ServeBursty"),
    ratios=(0.75, 0.5),
    prefetchers=("none", "block"),
    scale=0.25,
    window=None,
))

register_scenario(Scenario(
    name="chaos-smoke",
    description=(
        "CI smoke for the crash-safety plane: 2 small benchmarks x 1 "
        "oversubscribed ratio x 2 eviction policies x (none, tree) at "
        "scale 0.25 — 8 cells, sized so the chaos convergence harness "
        "(python -m repro.uvm.faults) can run it fault-free and under "
        "the bounded kill+corrupt+raise plan, with sweep restarts, in "
        "well under a minute (scripts/ci_check.sh)"),
    benches=("ATAX", "Pathfinder"),
    ratios=(0.75,),
    evictions=("lru", "hotcold"),
    prefetchers=("none", "tree"),
    scale=0.25,
))

register_scenario(Scenario(
    name="transformer-smoke",
    description=(
        "CI smoke for the predictor-family axis: 2 small benchmarks x 1 "
        "oversubscribed ratio x adaptive eviction x the learned "
        "prefetcher, across the simplified AND reference-Transformer "
        "families at scale 0.25 with short training — 4 cells proving "
        "rows record their model_family and a concretely resolved "
        "eviction policy through the pallas interpret-mode lanes "
        "(scripts/ci_check.sh)"),
    benches=("ATAX", "Pathfinder"),
    ratios=(0.75,),
    evictions=(ADAPTIVE_POLICY,),
    prefetchers=("learned",),
    model_families=("simplified", "transformer"),
    scale=0.25,
    service_steps=40,
))

#: multi-tenant bench pairs of the full interference matrix: diverse
#: pairings (streaming x wavefront, linear-algebra x stencil, ...) per
#: the shared-virtual-memory interference argument of arXiv 2405.06811
MT_BENCHES = ("ATAX+Pathfinder", "BICG+Hotspot", "MVT+StreamTriad",
              "Backprop+NW")

register_scenario(Scenario(
    name="mt-full",
    description=(
        "Multi-tenant interference matrix: 4 diverse benchmark pairs "
        "interleaved into one access stream x oversubscribed capacity "
        "ratios x capacity splits (shared contention, a hard 50/50 "
        "partition, and a 40/40 split leaving a 20% spill pool) x all "
        "eviction policies x all five prefetcher families; every row "
        "carries per-tenant hit rates and the interference slowdown vs. "
        "each tenant's solo replay"),
    benches=MT_BENCHES,
    ratios=(0.75, 0.5),
    capacity_splits=("shared", "0.5/0.5", "0.4/0.4"),
))

register_scenario(Scenario(
    name="mt-smoke",
    description=(
        "CI smoke for the multi-tenant plane: 1 interleaved pair x 2 "
        "oversubscribed ratios x 3 capacity splits (shared / hard 50-50 "
        "/ 40-40 + spill) x all eviction policies x (none, tree) at "
        "scale 0.25 — 36 cells on ONE shared trace, replayed through "
        "the pallas interpret-mode lanes; every row must record "
        "tenants, its capacity split, both per-tenant hit rates, and "
        "the interference slowdown (scripts/ci_check.sh)"),
    benches=("ATAX+Pathfinder",),
    ratios=(0.75, 0.5),
    capacity_splits=("shared", "0.5/0.5", "0.4/0.4"),
    prefetchers=("none", "tree"),
    scale=0.25,
))

register_scenario(Scenario(
    name="oversub-smoke",
    description=(
        "CI smoke: 2 small benchmarks x 2 oversubscribed ratios x all "
        "eviction policies x (none, tree) at scale 0.25 — the whole "
        "matrix stays under 100k accesses so the pallas interpret-mode "
        "lanes replay it in seconds"),
    benches=("ATAX", "Pathfinder"),
    ratios=(0.75, 0.5),
    prefetchers=("none", "tree"),
    scale=0.25,
))
