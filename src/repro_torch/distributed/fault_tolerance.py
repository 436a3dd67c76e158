"""Heartbeats and file leases, copied from the reference
``repro.distributed.fault_tolerance`` (which imports no JAX) so the port
stands alone.

* :class:`HeartbeatMonitor` tracks per-worker heartbeats; the sweep's
  lease-pool parent (``repro_torch.uvm.sweep``) terminates workers that
  fall silent so their leases free up.
* **File leases**: expiring, atomically acquired claim files that the
  sweep's per-cell execution and the prediction cache's training lock
  (``repro_torch.uvm.predcache``) both build on.  A lease is advisory:
  cell rows and prediction arrays are deterministic and written by atomic
  rename, so a benign double execution writes identical bytes; the lease
  exists so that crashed or stalled owners are reclaimed instead of
  wedging the grid.

* The straggler and re-mesh planners (:func:`plan_backup_dispatch`,
  :func:`plan_remesh`): pure policy a cluster controller would drive.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-host heartbeats; hosts silent past ``timeout_s`` are dead,
    hosts slower than ``straggler_factor`` x median step time are stragglers."""

    timeout_s: float = 60.0
    straggler_factor: float = 1.5

    def __post_init__(self) -> None:
        self.last_seen: Dict[int, float] = {}
        self.step_times: Dict[int, float] = {}

    def beat(self, host: int, step_time_s: float,
             now: Optional[float] = None) -> None:
        self.last_seen[host] = time.monotonic() if now is None else now
        # EWMA of step time
        prev = self.step_times.get(host, step_time_s)
        self.step_times[host] = 0.8 * prev + 0.2 * step_time_s

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def stragglers(self) -> List[int]:
        if len(self.step_times) < 2:
            return []
        times = sorted(self.step_times.values())
        median = times[len(times) // 2]
        return [h for h, t in self.step_times.items()
                if t > self.straggler_factor * median]


# ---------------------------------------------------------------------------
# file leases: crash-reclaimable claim files
# ---------------------------------------------------------------------------

def pid_alive(pid: int) -> bool:
    """True when ``pid`` names a live process on *this* host (signal-0
    probe; EPERM counts as alive — the process exists, we just cannot
    signal it)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - unprivileged probe
        return True
    except OSError:  # pragma: no cover - exotic platforms
        return True
    return True


def lease_doc(extra: Optional[Dict] = None) -> Dict:
    """The owner record a lease file carries: pid + host for the liveness
    check, a wall-clock timestamp for the TTL."""
    doc = {"pid": os.getpid(), "host": socket.gethostname(),
           "ts": time.time()}
    if extra:
        doc.update(extra)
    return doc


def read_lease(path: str) -> Optional[Dict]:
    """Parse a lease/lock file's owner record.  Returns None when the file
    is missing; a malformed or legacy (bare-pid) payload degrades to a
    partial record so staleness checks still work."""
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        return None
    try:
        doc = json.loads(raw)
        if isinstance(doc, dict):
            return doc
    except ValueError:
        pass
    try:                                     # legacy: bare pid, no ts
        return {"pid": int(raw.strip()), "host": socket.gethostname(),
                "ts": None}
    except ValueError:
        return {"pid": -1, "host": None, "ts": None}   # garbage: stale


def lease_is_stale(doc: Optional[Dict], ttl_s: float,
                   now: Optional[float] = None) -> bool:
    """A lease is stale when its TTL expired, or when the owner is a dead
    process on this host (SIGKILLed workers reclaim immediately instead
    of waiting out the TTL).  Unreadable records are stale."""
    if doc is None:
        return True
    ts = doc.get("ts")
    if ts is None or not isinstance(ts, (int, float)):
        return True
    now = time.time() if now is None else now
    if now - float(ts) > ttl_s:
        return True
    if doc.get("host") == socket.gethostname():
        pid = doc.get("pid")
        if not isinstance(pid, int) or not pid_alive(pid):
            return True
    return False


def try_acquire_lease(path: str, ttl_s: float,
                      extra: Optional[Dict] = None) -> bool:
    """Atomically claim a lease file (``O_CREAT|O_EXCL``); a stale
    holder's file is removed and the claim retried once.

    The steal has a benign race: two claimants can both observe the stale
    lease, both unlink, and one re-creates — in the worst interleaving a
    *fresh* lease is unlinked and two owners run concurrently.  Lease
    consumers must therefore be idempotent (deterministic work + atomic
    result rename), which every user in this repo is; the lease bounds
    duplicated work, it does not guarantee exclusion.
    """
    for _ in range(2):
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if not lease_is_stale(read_lease(path), ttl_s):
                return False
            try:
                os.unlink(path)
            except OSError:
                pass
            continue
        except OSError:                       # dir vanished mid-claim
            return False
        with os.fdopen(fd, "w") as f:
            json.dump(lease_doc(extra), f)
        return True
    return False


def renew_lease(path: str, extra: Optional[Dict] = None) -> None:
    """Refresh the TTL of a lease this process holds (atomic rewrite)."""
    tmp = path + f".renew.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(lease_doc(extra), f)
        os.replace(tmp, path)
    except OSError:  # pragma: no cover - dir vanished
        try:
            os.unlink(tmp)
        except OSError:
            pass


def release_lease(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def plan_backup_dispatch(stragglers: List[int], spares: List[int]
                         ) -> Dict[int, int]:
    """Deadline-based straggler mitigation: map each straggler's micro-batch
    onto a spare host (first-finisher wins, loser's result is dropped)."""
    return {s: spare for s, spare in zip(stragglers, spares)}


def plan_remesh(n_hosts_alive: int, chips_per_host: int,
                model_parallel: int,
                pods: Tuple[int, ...] = (4, 2, 1)) -> Optional[Tuple[int, int, int]]:
    """Pick the largest (pod, data, model) mesh the surviving chips support,
    preserving the model axis (weight layouts stay valid on restore)."""
    chips = n_hosts_alive * chips_per_host
    for pod in pods:
        if chips % pod:
            continue
        per_pod = chips // pod
        if per_pod % model_parallel:
            continue
        data = per_pod // model_parallel
        if data >= 1:
            return (pod, data, model_parallel)
    return None
