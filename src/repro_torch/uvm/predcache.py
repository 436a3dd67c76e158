"""Content-addressed cache of learned-prefetcher prediction arrays, ported
from the reference ``repro.uvm.predcache``: an in-process memo, a
checksummed disk store and a training lock, so a (trace × prediction_us ×
device_frac) grid trains one predictor per (trace, model) pair, across
processes too.

* Keys hash the trace's access records and instruction count, every
  ``PredictorService`` field that shapes the predictions (including the
  model family and the digest of its resolved config), the cache format
  version, and the implementation tag ``torch``: arrays the JAX package
  trained never share a key with the port's.
* Values are single ``.npz`` files holding the array and its sha256,
  written by atomic rename (the ``pred.artifact`` fault site fires after
  it); an entry whose checksum fails is quarantined to ``<entry>.corrupt``
  with a warning and retrained.
* A training lock, a crash-reclaimable lease
  (``repro_torch.distributed.fault_tolerance``), makes concurrent misses on
  one key wait for the first trainer's array instead of training again: a
  lock whose owner pid is dead or whose TTL expired is stolen at once, a
  holder that stored a corrupt entry is stolen without waiting, and a live
  but wedged holder is overridden after ``lock_patience_s``.

``REPRO_PREDCACHE=0`` disables every cache (one training per call).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
import warnings
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.distributed import fault_tolerance as ft
from repro_torch.uvm import faults

#: the reference's key schema version (3: model identity in the key)
PREDCACHE_VERSION = 3

#: tells the port's arrays apart from the JAX package's under one key schema
IMPL_TAG = "torch"

#: conventional subdirectory name under a sweep's cache directory
DEFAULT_SUBDIR = "pred_cache"

#: PredictorService fields that determine the predictions array
SERVICE_KEY_FIELDS = ("cluster_key", "distance", "min_prob", "seq_len",
                      "steps", "batch_size", "quantize", "bypass_threshold",
                      "seed", "model_family", "model_config")

_MEMO: Dict[str, np.ndarray] = {}


def clear_memo() -> None:
    """Drop the in-process memo (tests)."""
    _MEMO.clear()


def enabled() -> bool:
    return os.environ.get("REPRO_PREDCACHE", "1") != "0"


def trace_content_key(trace) -> str:
    """sha256 over the raw access records and the instruction count.  The
    access array is frozen when the key is memoized on the trace, so a later
    in-place mutation raises instead of reusing a stale key."""
    key = getattr(trace, "_predcache_content_key", None)
    if key is not None:
        return key
    acc = np.ascontiguousarray(trace.accesses)
    h = hashlib.sha256()
    h.update(str(acc.dtype).encode())
    h.update(str(acc.shape).encode())
    h.update(acc.tobytes())
    h.update(str(int(trace.n_instructions)).encode())
    key = h.hexdigest()[:24]
    try:
        trace.accesses.flags.writeable = False
        trace._predcache_content_key = key
    except (AttributeError, ValueError):
        pass
    return key


def predictions_key(trace, **service_fields) -> str:
    """Cache key for one (trace content, predictor config) pair."""
    blob = json.dumps({"_v": PREDCACHE_VERSION, "impl": IMPL_TAG,
                       "trace": trace_content_key(trace),
                       **service_fields}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"preds_{key}.npz")


def _preds_digest(preds: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(preds.dtype).encode())
    h.update(str(preds.shape).encode())
    h.update(np.ascontiguousarray(preds).tobytes())
    return h.hexdigest()


def load_checked(cache_dir: str, key: str
                 ) -> Tuple[Optional[np.ndarray], bool]:
    """A cached array and whether the entry was corrupt: ``(array, False)``
    on a hit, ``(None, False)`` on a miss, ``(None, True)`` when the entry
    was unreadable or failed its checksum (it is quarantined).  A corrupt
    entry tells a lock waiter that the holder already finished and failed
    its write, so waiting out its lease cannot bring a good array."""
    path = _path(cache_dir, key)
    try:
        with np.load(path, allow_pickle=False) as z:
            preds = np.ascontiguousarray(z["preds"])
            sha = str(z["sha"])
    except (FileNotFoundError, NotADirectoryError):
        return None, False
    except (ValueError, EOFError, OSError, KeyError, zipfile.BadZipFile):
        _quarantine(path, "unreadable prediction cache entry")
        return None, True
    if sha != _preds_digest(preds):
        _quarantine(path, "prediction cache checksum mismatch")
        return None, True
    preds.flags.writeable = False
    return preds, False


def load(cache_dir: str, key: str) -> Optional[np.ndarray]:
    """A cached array, or None on a miss (:func:`load_checked` without the
    corrupt flag)."""
    return load_checked(cache_dir, key)[0]


def _quarantine(path: str, reason: str) -> None:
    warnings.warn(f"{reason}: quarantining {path} -> {path}.corrupt and "
                  "retraining", RuntimeWarning)
    try:
        os.replace(path, path + ".corrupt")
    except OSError:
        pass


def store(cache_dir: str, key: str, preds: np.ndarray) -> str:
    """Atomically persist an array with its checksum (same-directory
    tempfile, then ``os.replace``)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = _path(cache_dir, key)
    arr = np.ascontiguousarray(preds)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix=f".{key}.",
                               suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, preds=arr, sha=np.array(_preds_digest(arr)))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    faults.corrupt("pred.artifact", path, key)
    return path


def _try_lock(lock_path: str, ttl_s: float) -> bool:
    """Claim a key's training lock, a lease file ({pid, host, ts}): a
    holder SIGKILLed on this host is stolen at once (dead pid), one
    elsewhere once its TTL expires; bare-pid lock files read as stale."""
    return ft.try_acquire_lease(lock_path, ttl_s,
                                extra={"role": "predcache-train"})


def _unlock(lock_path: str) -> None:
    ft.release_lease(lock_path)


def get_or_train(trace, *, steps: int = 150, seed: int = 0,
                 cache_dir: Optional[str] = None,
                 service_kwargs: Optional[Dict] = None,
                 device: str = "cuda",
                 timings: Optional[Dict[str, float]] = None,
                 lock_poll_s: float = 0.25,
                 lock_patience_s: float = 900.0) -> np.ndarray:
    """The ``predict_trace`` array for (trace, predictor config), training
    at most once per key across the memo, the disk cache and, through the
    lock, concurrent processes.  When this call trains, ``timings`` (if
    given) receives ``train_s`` (fit, including the evaluation pass),
    ``predict_s``, the fit's held-out ``top1`` and ``f1``, and
    ``coverage``, the share of accesses with a gated prediction (what
    ``benchmarks/family_accuracy.py`` reports per family)."""
    from repro_torch.core.service import PredictorService

    def _service() -> "PredictorService":
        return PredictorService(steps=steps, seed=seed, device=device,
                                **(service_kwargs or {}))

    def _train() -> np.ndarray:
        svc = _service()
        t0 = time.perf_counter()
        svc.fit(trace)
        t1 = time.perf_counter()
        preds = np.ascontiguousarray(svc.predict_trace(), dtype=np.int64)
        t2 = time.perf_counter()
        preds.flags.writeable = False
        if timings is not None:
            timings.update(train_s=t1 - t0, predict_s=t2 - t1,
                           top1=float(svc.result.metrics["top1"]),
                           f1=float(svc.result.metrics["f1"]),
                           coverage=float(np.mean(preds >= 0)))
        return preds

    if not enabled():
        return _train()
    probe = _service()
    key = predictions_key(trace, **{f: getattr(probe, f)
                                    for f in SERVICE_KEY_FIELDS})
    preds = _MEMO.get(key)
    if preds is not None:
        return preds
    if cache_dir is None:
        preds = _MEMO[key] = _train()
        return preds

    preds, corrupt = load_checked(cache_dir, key)
    if preds is None:
        os.makedirs(cache_dir, exist_ok=True)
        lock = _path(cache_dir, key) + ".lock"
        got = _try_lock(lock, lock_patience_s)
        if not got and corrupt:
            # a corrupt entry under a live lock: its holder trained, stored
            # and failed, so waiting cannot bring a good array
            _unlock(lock)
            got = _try_lock(lock, lock_patience_s)
        if not got:
            # another live process trains this key: wait for its array,
            # re-probing the lease each poll so a holder that dies is
            # reclaimed at once
            deadline = time.monotonic() + lock_patience_s
            while time.monotonic() < deadline:
                preds, corrupt = load_checked(cache_dir, key)
                if preds is not None:
                    break
                if corrupt:
                    _unlock(lock)
                    got = _try_lock(lock, lock_patience_s)
                    break
                if _try_lock(lock, lock_patience_s):
                    got = True           # holder released, died, or TTL'd
                    break
                time.sleep(lock_poll_s)
            if preds is None and not got:
                # patience spent: the holder is alive but wedged; steal the
                # lock (the worst case is a duplicate, identical training)
                _unlock(lock)
                got = _try_lock(lock, lock_patience_s)
        if preds is None:
            try:
                preds = load(cache_dir, key)   # double-check under the lock
                if preds is None:
                    preds = _train()
                    store(cache_dir, key, preds)
            finally:
                if got:
                    _unlock(lock)
    _MEMO[key] = preds
    return preds
