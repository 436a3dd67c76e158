"""Deterministic fault-injection plane and chaos convergence harness of the
port, a copy of the reference ``repro.uvm.faults`` (which imports no JAX)
with its imports pointed at the port.

Sweep grids (the 660-cell ``oversub-full`` matrix and bigger) must survive
killed workers, torn result files, corrupted cached artifacts and transient
backend faults, and converge to the same rows when they do:

* A **fault plan** (:class:`FaultPlan`) is a seed-driven, JSON-serializable
  spec of faults to inject at named *sites* of the sweep: worker kills
  (``SIGKILL``, no cleanup), injected exceptions, delays, and artifact
  corruption (truncation, bit flips) of cell rows, cached traces and
  prediction-cache entries.
* Whether a (site, key) fires is a **deterministic** function of the plan
  seed, and every spec carries a ``max_count`` budget enforced through an
  on-disk **ledger** (atomic ``O_EXCL`` claim files) shared across
  processes and driver restarts, so a retried cell stops being sabotaged
  and the sweep converges.
* The plan rides in the ``REPRO_FAULT_PLAN`` environment variable (inline
  JSON, or a path to a JSON file), in the reference's format: a plan
  written by either package loads in the other, and spawned workers and
  restarted drivers see it without plumbing.
* The **chaos harness** (:func:`chaos_converge`, CLI below) drives the
  port's sweep CLI under a plan, restarting the driver when a kill takes it
  down, and proves the final rows equal a fault-free baseline under
  :func:`rows_digest`, with an empty quarantine manifest.

One departure: :data:`VOLATILE_ROW_FIELDS` holds the reference's
``seconds`` and ``retries`` and also the port's five execution columns
(``train_seconds``, ``predict_seconds``, ``fit_top1``, ``fit_f1``,
``fit_coverage``): they depend on timing and on which process trained a
key first, so a resumed or retried learned grid differs in them from a
fault-free one.  Every column the reference writes is still compared,
``backend`` and ``quarantined`` included.

Injection sites
---------------

==========================  =================  =============================
site                        kinds              where it fires
==========================  =================  =============================
``cell.start``              kill, raise,       entering a leased cell
                            delay              attempt (``repro_torch.uvm.
                                               sweep``)
``cell.result.write``       kill               after a cell row's tempfile
                                               is written, *before* the
                                               atomic rename (torn write)
``cell.result.artifact``    truncate, bitflip  the persisted
                                               ``cells/<key>.json`` after
                                               the rename (fs corruption)
``trace.artifact``          truncate, bitflip  a cached trace ``.npz`` after
                                               its atomic rename
``pred.artifact``           truncate, bitflip  a prediction-cache entry
                                               after its atomic rename
``backend.replay``          raise, delay       entering K1's lane backend
                                               (``CudaReplayBackend.replay``;
                                               raises a *transient* backend
                                               fault: the cell is retried
                                               on the same backend, never
                                               degraded)
``lane.flush``              kill, delay        before a K1 lane batch in
                                               the sweep
``worker.loop``             kill, delay        a lease worker between cells
==========================  =================  =============================

CLI::

    PYTHONPATH=src python -m repro_torch.uvm.faults --scenario chaos-smoke \
        --backend numpy --device cpu --workers 2 --out /tmp/chaos
    PYTHONPATH=src python -m repro_torch.uvm.faults --scenario chaos-smoke \
        --backend cuda --out /tmp/chaos

runs the scenario fault-free (baseline), then under a kill+corrupt+raise
plan with driver restarts, and exits nonzero unless every cell converged
with an empty quarantine manifest.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: environment variable carrying the active plan: inline JSON (starts with
#: ``{``) or a path to a JSON file
FAULT_PLAN_ENV = "REPRO_FAULT_PLAN"

SITES = ("cell.start", "cell.result.write", "cell.result.artifact",
         "trace.artifact", "pred.artifact", "backend.replay", "lane.flush",
         "worker.loop")
KINDS = ("kill", "raise", "delay", "truncate", "bitflip")

#: sites where a fault acts on a file (the ``path`` argument is required)
_ARTIFACT_KINDS = ("truncate", "bitflip")

#: row columns excluded from convergence digests: timing, the retry counter
#: and the port's training columns are execution metadata, everything else
#: must be byte-identical between a chaotic and a fault-free run
VOLATILE_ROW_FIELDS = ("seconds", "retries", "train_seconds",
                       "predict_seconds", "fit_top1", "fit_f1",
                       "fit_coverage")


class InjectedFault(RuntimeError):
    """An exception injected by the fault plane (``kind="raise"``)."""


# imported lazily where needed to keep this module numpy/torch-free
def _transient_base():
    from repro_torch.uvm.replay_core import TransientBackendFault
    return TransientBackendFault


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault rule: *what* to inject (``kind``), *where* (``site``,
    optionally narrowed to keys containing ``match``), with what
    probability per (site, key) draw, and at most how many times overall
    (``max_count``; ``None`` = unbounded — convergence plans must bound
    every destructive spec)."""

    site: str
    kind: str
    prob: float = 1.0
    max_count: Optional[int] = 1
    match: Optional[str] = None
    delay_s: float = 0.05        # kind="delay"
    fraction: float = 0.5        # kind="truncate": bytes kept

    def validate(self) -> "FaultSpec":
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"choose from {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {KINDS}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"fault prob must be in [0, 1], "
                             f"got {self.prob}")
        if self.max_count is not None and self.max_count < 1:
            raise ValueError(f"max_count must be >= 1 or None, "
                             f"got {self.max_count}")
        if not 0.0 <= self.fraction < 1.0:
            raise ValueError(f"truncate fraction must be in [0, 1), "
                             f"got {self.fraction}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        return self


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus fault specs plus the shared ledger directory that
    enforces ``max_count`` across processes and driver restarts."""

    seed: int
    specs: Tuple[FaultSpec, ...]
    ledger_dir: Optional[str] = None

    def validate(self) -> "FaultPlan":
        for spec in self.specs:
            spec.validate()
            if spec.max_count is not None and self.ledger_dir is None:
                raise ValueError(
                    f"spec {spec.site}/{spec.kind} has max_count="
                    f"{spec.max_count} but the plan has no ledger_dir — "
                    "bounded faults need the on-disk ledger to stay "
                    "bounded across workers and driver restarts")
        return self

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


def plan_from_dict(doc: Dict) -> FaultPlan:
    specs = tuple(FaultSpec(**s) for s in doc.get("specs", ()))
    return FaultPlan(seed=int(doc.get("seed", 0)), specs=specs,
                     ledger_dir=doc.get("ledger_dir")).validate()


def load_plan(source: str) -> FaultPlan:
    """Parse a plan from inline JSON or a path to a JSON file."""
    text = source.strip()
    if not text.startswith("{"):
        with open(text) as f:
            text = f.read()
    return plan_from_dict(json.loads(text))


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

def _draw(seed: int, spec_index: int, site: str, key: str) -> float:
    """Deterministic uniform draw in [0, 1) for one (spec, site, key)."""
    blob = f"{seed}|{spec_index}|{site}|{key}".encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big") / 2**64


class FaultInjector:
    """Evaluates a plan at injection sites.  Thread-compatible, cheap when
    no spec matches a site."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan.validate()
        self._local_counts: Dict[Tuple[int, str], int] = {}

    # -- ledger ---------------------------------------------------------
    def _claim(self, spec_index: int, spec: FaultSpec, key: str) -> bool:
        """Claim one firing slot.  With a ``max_count``, slots are atomic
        ``O_EXCL`` files in the ledger dir — shared across processes —
        keyed per (spec, site, key) so a retried cell is sabotaged at
        most ``max_count`` times and then left alone."""
        if spec.max_count is None:
            return True
        token = hashlib.sha256(
            f"{spec_index}|{spec.site}|{key}".encode()).hexdigest()[:20]
        if self.plan.ledger_dir is None:      # unreachable post-validate
            n = self._local_counts.get((spec_index, key), 0)
            if n >= spec.max_count:
                return False
            self._local_counts[(spec_index, key)] = n + 1
            return True
        os.makedirs(self.plan.ledger_dir, exist_ok=True)
        for slot in range(spec.max_count):
            path = os.path.join(self.plan.ledger_dir,
                                f"fired_{token}_{slot}")
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue
            with os.fdopen(fd, "w") as f:
                f.write(f"{spec.site} {spec.kind} {key} pid={os.getpid()}")
            return True
        return False

    def _matching(self, site: str, key: str,
                  kinds: Tuple[str, ...]) -> List[Tuple[int, FaultSpec]]:
        out = []
        for i, spec in enumerate(self.plan.specs):
            if spec.site != site or spec.kind not in kinds:
                continue
            if spec.match is not None and spec.match not in key:
                continue
            out.append((i, spec))
        return out

    # -- control-flow faults -------------------------------------------
    def fire(self, site: str, key: str) -> None:
        """Inject kill / raise / delay faults at a control-flow site."""
        for i, spec in self._matching(site, key,
                                      ("kill", "raise", "delay")):
            if _draw(self.plan.seed, i, site, key) >= spec.prob:
                continue
            if not self._claim(i, spec, key):
                continue
            if spec.kind == "delay":
                time.sleep(spec.delay_s)
            elif spec.kind == "raise":
                if site == "backend.replay":
                    base = _transient_base()

                    class _InjectedBackendFault(InjectedFault, base):
                        pass
                    raise _InjectedBackendFault(
                        f"injected transient backend fault at {site} "
                        f"({key})")
                raise InjectedFault(f"injected fault at {site} ({key})")
            elif spec.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)

    # -- artifact faults -----------------------------------------------
    def corrupt(self, site: str, path: str, key: str) -> None:
        """Inject truncation / bit-flip corruption into a finished
        artifact (fires *after* the writer's atomic rename, simulating
        filesystem rot a later reader must detect and quarantine)."""
        for i, spec in self._matching(site, key, _ARTIFACT_KINDS):
            if _draw(self.plan.seed, i, site, key) >= spec.prob:
                continue
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if size == 0 or not self._claim(i, spec, key):
                continue
            if spec.kind == "truncate":
                os.truncate(path, int(size * spec.fraction))
            else:                             # bitflip
                offset = int(_draw(self.plan.seed, i, "offset", key)
                             * size * 8)
                byte_i, bit_i = offset // 8, offset % 8
                with open(path, "r+b") as f:
                    f.seek(byte_i)
                    b = f.read(1)
                    f.seek(byte_i)
                    f.write(bytes([b[0] ^ (1 << bit_i)]))


# ---------------------------------------------------------------------------
# process-level plumbing (the sites call these free functions)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None
_ACTIVE_RAW: Optional[str] = None


def active() -> Optional[FaultInjector]:
    """The process's injector, rebuilt whenever ``REPRO_FAULT_PLAN``
    changes (spawned workers inherit the env and build their own)."""
    global _ACTIVE, _ACTIVE_RAW
    raw = os.environ.get(FAULT_PLAN_ENV)
    if raw != _ACTIVE_RAW:
        _ACTIVE_RAW = raw
        _ACTIVE = FaultInjector(load_plan(raw)) if raw else None
    return _ACTIVE


def reset() -> None:
    """Drop the cached injector (tests)."""
    global _ACTIVE, _ACTIVE_RAW
    _ACTIVE = None
    _ACTIVE_RAW = None


def fire(site: str, key: str) -> None:
    inj = active()
    if inj is not None:
        inj.fire(site, key)


def corrupt(site: str, path: str, key: str) -> None:
    inj = active()
    if inj is not None:
        inj.corrupt(site, path, key)


# ---------------------------------------------------------------------------
# convergence digests
# ---------------------------------------------------------------------------

def rows_digest(rows: Sequence[Dict],
                ignore: Sequence[str] = VOLATILE_ROW_FIELDS) -> str:
    """Canonical sha256 of a result-row list minus the volatile
    execution-metadata columns.  Two sweeps converged iff their digests
    are equal — every remaining column, ``backend`` and ``quarantined``
    included, must match byte-for-byte."""
    ignore = set(ignore)
    canon = [{k: v for k, v in sorted(row.items()) if k not in ignore}
             for row in rows]
    return hashlib.sha256(
        json.dumps(canon, sort_keys=True).encode()).hexdigest()


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------

def default_chaos_plan(ledger_dir: str, seed: int = 0) -> FaultPlan:
    """The reference kill+corrupt+raise+delay plan the smoke check runs:
    every destructive spec is bounded, so a resumed sweep always
    converges once the ledger fills."""
    return FaultPlan(seed=seed, ledger_dir=ledger_dir, specs=(
        FaultSpec("cell.start", "kill", prob=0.4, max_count=2),
        FaultSpec("cell.start", "raise", prob=0.4, max_count=2),
        FaultSpec("cell.start", "delay", prob=0.3, max_count=4,
                  delay_s=0.05),
        FaultSpec("cell.result.write", "kill", prob=0.3, max_count=2),
        FaultSpec("cell.result.artifact", "bitflip", prob=0.4,
                  max_count=2),
        FaultSpec("cell.result.artifact", "truncate", prob=0.3,
                  max_count=1),
        FaultSpec("trace.artifact", "truncate", prob=0.5, max_count=1),
        FaultSpec("backend.replay", "raise", prob=0.5, max_count=2),
        FaultSpec("lane.flush", "kill", prob=0.3, max_count=1),
        FaultSpec("worker.loop", "kill", prob=0.3, max_count=2),
    ))


#: sites whose faults burn one *cell attempt* each time they fire: the
#: fault lands after the attempt counter was bumped under the lease
#: (cell.start, backend.replay, cell.result.write), or it corrupts the
#: committed row so a later resume requeues the cell (cell.result.artifact)
_ATTEMPT_CONSUMING_SITES = ("cell.start", "cell.result.write",
                            "cell.result.artifact", "backend.replay")


def attempt_budget(plan: FaultPlan, margin: int = 2) -> int:
    """The quarantine threshold a *recoverable* plan needs: in the worst
    case every attempt-consuming spec spends its whole ``max_count``
    budget on the same cell, so the cell must be allowed that many failed
    attempts plus ``margin`` real ones before quarantine kicks in.  The
    chaos harness exports this as ``REPRO_SWEEP_MAX_ATTEMPTS`` — with the
    stock threshold, a heavily-sabotaged cell would quarantine and the
    convergence check would (correctly) fail."""
    sabotage = sum(spec.max_count or 0 for spec in plan.specs
                   if spec.site in _ATTEMPT_CONSUMING_SITES
                   and spec.kind != "delay")
    return sabotage + margin


def _sweep_argv(out_dir: str, *, scenario: Optional[str] = None,
                benches: Optional[str] = None,
                prefetchers: Optional[str] = None,
                backend: str = "numpy", engine: str = "auto",
                workers: int = 1, scale: Optional[float] = None,
                device: str = "cuda") -> List[str]:
    argv = [sys.executable, "-m", "repro_torch.uvm.sweep", "--out", out_dir,
            "--backend", backend, "--engine", engine,
            "--workers", str(workers), "--device", device]
    if scenario:
        argv += ["--scenario", scenario]
    else:
        argv += ["--benches", benches or "ATAX,Pathfinder",
                 "--prefetchers", prefetchers or "none,tree"]
        if scale is not None:
            argv += ["--scales", str(scale)]
    return argv


def _run_env(plan: Optional[FaultPlan]) -> Dict[str, str]:
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    if plan is None:
        env.pop(FAULT_PLAN_ENV, None)
    else:
        env[FAULT_PLAN_ENV] = plan.to_json()
    return env


def chaos_converge(argv: List[str], plan: FaultPlan, *,
                   max_restarts: int = 30,
                   env_extra: Optional[Dict[str, str]] = None,
                   verbose: bool = False) -> int:
    """Run a sweep command under ``plan``, restarting the driver process
    every time an injected kill (or any crash) takes it down, until it
    exits cleanly.  Returns the number of restarts; raises RuntimeError
    when the restart budget is exhausted (a fault plan whose destructive
    specs are not all bounded can loop forever — that is a plan bug)."""
    env = _run_env(plan)
    if env_extra:
        env.update(env_extra)
    restarts = 0
    while True:
        proc = subprocess.run(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if proc.returncode == 0:
            return restarts
        restarts += 1
        if verbose:
            tail = proc.stdout.decode(errors="replace").strip()
            print(f"[chaos] driver died (rc={proc.returncode}), "
                  f"restart {restarts}/{max_restarts}; tail:\n"
                  + "\n".join(tail.splitlines()[-4:]), flush=True)
        if restarts > max_restarts:
            raise RuntimeError(
                f"chaos sweep did not converge within {max_restarts} "
                f"driver restarts — is every destructive fault spec "
                f"bounded by max_count?  last output:\n"
                + proc.stdout.decode(errors="replace")[-2000:])


def run_chaos_check(out_dir: str, *, scenario: Optional[str] = None,
                    benches: Optional[str] = None,
                    prefetchers: Optional[str] = None,
                    backend: str = "numpy", engine: str = "auto",
                    workers: int = 1, seed: int = 0,
                    scale: Optional[float] = None,
                    plan: Optional[FaultPlan] = None,
                    max_restarts: int = 30,
                    device: str = "cuda",
                    verbose: bool = True) -> Dict:
    """The full convergence check: fault-free baseline, chaotic run with
    driver restarts, then digest + quarantine comparison.

    Returns a report dict; raises AssertionError on divergence, lost
    cells, or a non-empty quarantine manifest (recoverable faults must
    never quarantine a cell)."""
    from repro_torch.uvm.sweep import read_results

    base_out = os.path.join(out_dir, "baseline")
    chaos_out = os.path.join(out_dir, "chaos")
    ledger = os.path.join(out_dir, "ledger")
    if plan is None:
        plan = default_chaos_plan(ledger, seed=seed)

    kw = dict(scenario=scenario, benches=benches, prefetchers=prefetchers,
              backend=backend, engine=engine, workers=workers, scale=scale,
              device=device)
    if verbose:
        print(f"[chaos] baseline run -> {base_out}", flush=True)
    proc = subprocess.run(_sweep_argv(base_out, **kw), env=_run_env(None),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError("fault-free baseline failed:\n"
                           + proc.stdout.decode(errors="replace")[-2000:])
    if verbose:
        print(f"[chaos] chaotic run under plan (seed={plan.seed}, "
              f"{len(plan.specs)} specs) -> {chaos_out}", flush=True)
    restarts = chaos_converge(
        _sweep_argv(chaos_out, **kw), plan, max_restarts=max_restarts,
        env_extra={"REPRO_SWEEP_MAX_ATTEMPTS": str(attempt_budget(plan))},
        verbose=verbose)

    base_rows = read_results(base_out)
    chaos_rows = read_results(chaos_out)
    assert len(chaos_rows) == len(base_rows), (
        f"lost cells: chaos run has {len(chaos_rows)} rows, "
        f"baseline {len(base_rows)}")
    quarantined = [r for r in chaos_rows if r.get("quarantined")]
    assert not quarantined, (
        f"{len(quarantined)} cells quarantined under a recoverable fault "
        f"plan: {[(r['bench'], r['prefetcher']) for r in quarantined]}")
    with open(os.path.join(chaos_out, "quarantine.json")) as f:
        manifest = json.load(f)
    assert manifest["cells"] == [], manifest
    d_base, d_chaos = rows_digest(base_rows), rows_digest(chaos_rows)
    assert d_base == d_chaos, (
        "chaos run diverged from the fault-free baseline: "
        f"{d_chaos} != {d_base} — first differing row: "
        + next((f"{b} vs {c}" for b, c in zip(base_rows, chaos_rows)
                if {k: v for k, v in b.items()
                    if k not in VOLATILE_ROW_FIELDS}
                != {k: v for k, v in c.items()
                    if k not in VOLATILE_ROW_FIELDS}), "<none>"))
    retries = sum(int(r.get("retries") or 0) for r in chaos_rows)
    fired = (len(os.listdir(ledger)) if os.path.isdir(ledger) else 0)
    report = {"cells": len(chaos_rows), "restarts": restarts,
              "retries": retries, "faults_fired": fired,
              "digest": d_base}
    if verbose:
        print(f"[chaos] converged: {report['cells']} cells byte-identical "
              f"to baseline after {fired} injected faults, "
              f"{restarts} driver restarts, {retries} cell retries; "
              "quarantine empty", flush=True)
    return report


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Chaos convergence check: sweep under an injected "
                    "fault plan must produce rows byte-identical to a "
                    "fault-free baseline")
    ap.add_argument("--scenario", default=None,
                    help="scenario to drive (e.g. chaos-smoke); "
                         "alternatively --benches/--prefetchers")
    ap.add_argument("--benches", default=None)
    ap.add_argument("--prefetchers", default=None)
    ap.add_argument("--scale", type=float, default=None,
                    help="trace scale of the --benches grid")
    ap.add_argument("--backend", default="numpy",
                    choices=["auto", "numpy", "cuda"],
                    help="first backend of each cell's chain: numpy, or "
                         "cuda/auto (K1 lane batches in the sweep driver)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweeps (cpu runs K1's plain "
                         "version)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "vectorized", "legacy"])
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", default=None,
                    help="fault plan (inline JSON or a file path); "
                         "default: the built-in bounded kill+corrupt+"
                         "raise plan")
    ap.add_argument("--max-restarts", type=int, default=30)
    ap.add_argument("--out", required=True,
                    help="working directory (baseline/, chaos/, ledger/)")
    args = ap.parse_args(argv)

    plan = None
    if args.plan:
        plan = load_plan(args.plan)
    report = run_chaos_check(
        args.out, scenario=args.scenario, benches=args.benches,
        prefetchers=args.prefetchers, backend=args.backend,
        engine=args.engine, workers=args.workers, seed=args.seed,
        scale=args.scale, plan=plan, max_restarts=args.max_restarts, device=args.device)
    print(json.dumps(report, sort_keys=True))


if __name__ == "__main__":
    main()
