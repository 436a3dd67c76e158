"""Content-addressed cache of learned-prefetcher prediction arrays, ported
from the reference ``repro.uvm.predcache``: an in-process memo and a
checksummed disk store, so a (trace × prediction_us × device_frac) grid
trains one predictor per (trace, model) pair.

* Keys hash the trace's access records and instruction count, every
  ``PredictorService`` field that shapes the predictions (including the
  model family and the digest of its resolved config), the cache format
  version, and the implementation tag ``torch``: arrays the JAX package
  trained never share a key with the port's.
* Values are single ``.npz`` files holding the array and its sha256,
  written by atomic rename; an entry whose checksum fails is quarantined to
  ``<entry>.corrupt`` with a warning and retrained.

The reference's training lease and fault-injection hooks are not ported.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
import warnings
import zipfile
from typing import Dict, Optional

import numpy as np

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


def load(cache_dir: str, key: str) -> Optional[np.ndarray]:
    """A cached array, or None on a miss.  An unreadable or
    checksum-failing entry is quarantined and reads as a miss."""
    path = _path(cache_dir, key)
    try:
        with np.load(path, allow_pickle=False) as z:
            preds = np.ascontiguousarray(z["preds"])
            sha = str(z["sha"])
    except (FileNotFoundError, NotADirectoryError):
        return None
    except (ValueError, EOFError, OSError, KeyError, zipfile.BadZipFile):
        _quarantine(path, "unreadable prediction cache entry")
        return None
    if sha != _preds_digest(preds):
        _quarantine(path, "prediction cache checksum mismatch")
        return None
    preds.flags.writeable = False
    return preds


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
    return path


def get_or_train(trace, *, steps: int = 150, seed: int = 0,
                 cache_dir: Optional[str] = None,
                 service_kwargs: Optional[Dict] = None,
                 device: str = "cuda",
                 timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """The ``predict_trace`` array for (trace, predictor config), training
    at most once per key across the memo and the disk cache.  When this
    call trains, ``timings`` (if given) receives ``train_s`` (fit, including
    the evaluation pass) and ``predict_s``."""
    from repro_torch.core.service import PredictorService

    svc = PredictorService(steps=steps, seed=seed, device=device,
                           **(service_kwargs or {}))
    key = predictions_key(trace, **{f: getattr(svc, f)
                                    for f in SERVICE_KEY_FIELDS})
    preds = _MEMO.get(key)
    if preds is None and cache_dir is not None:
        preds = load(cache_dir, key)
    if preds is None:
        t0 = time.perf_counter()
        svc.fit(trace)
        t1 = time.perf_counter()
        preds = np.ascontiguousarray(svc.predict_trace(), dtype=np.int64)
        t2 = time.perf_counter()
        preds.flags.writeable = False
        if timings is not None:
            timings.update(train_s=t1 - t0, predict_s=t2 - t1)
        if cache_dir is not None:
            store(cache_dir, key, preds)
    _MEMO[key] = preds
    return preds
