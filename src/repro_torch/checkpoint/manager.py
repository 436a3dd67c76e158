"""Checkpoint manager built for preemptible fleets, as the reference's
``repro.checkpoint.manager`` lays it out.

* **Atomic**: checkpoints are written to ``step_<n>.tmp/`` and committed via
  a single directory rename: a killed writer never corrupts the latest
  checkpoint.
* **Async**: ``save_async`` copies the tensors to host memory (blocking only
  on the copy) and writes them on a background thread; ``wait`` joins it and
  raises if a write failed.
* **Integrity**: ``manifest.json`` holds the step, the leaf count, the
  leaves' names (``treedef``) and types, the ``extra`` dict and a checksum
  per ``leaf_<i>.npy``; ``restore`` raises ``IOError`` on a checksum
  mismatch and ``ValueError`` when the template's leaves differ.
* **Pipeline state**: the data-iterator state dict rides along in
  ``extra``, so resume is exact, not approximate.

Leaves are the tensors of a tree in a fixed order: an ``nn.Module``'s
``named_parameters()`` (for ``LMParams``), or a nested dict's values in
sorted key order (as JAX flattens a dict).
A restore returns the type that was saved, not the template's.  numpy has
no bfloat16: a bf16 tensor is stored without loss as its bits (``uint16``),
its type recorded in the manifest, and restored as bf16.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import set_data


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._errors: list = []
        self.write_s: List[float] = []     # seconds of each completed write

    # ------------------------------------------------------------------
    def save(self, step: int, params: Any,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Synchronous atomic save."""
        return self._write(step, _to_host(params), extra or {})

    def save_async(self, step: int, params: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot to host memory now; write in the background."""
        host = _to_host(params)
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        self._q.put((step, host, extra or {}))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise RuntimeError(f"async checkpoint failures: {self._errors}")

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                self._write(*item)
            except Exception as e:  # pragma: no cover
                self._errors.append(e)
            finally:
                self._q.task_done()

    # ------------------------------------------------------------------
    def _write(self, step: int, host: List[Tuple[str, np.ndarray, str]],
               extra: Dict[str, Any]) -> str:
        t0 = time.perf_counter()
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "n_leaves": len(host),
                    "treedef": [name for name, _, _ in host],
                    "dtypes": [dtype for _, _, dtype in host],
                    "extra": extra, "checksums": []}
        for i, (_, arr, _) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
            manifest["checksums"].append(_checksum(arr))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._gc()
        self.write_s.append(time.perf_counter() - t0)
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``template``; returns (restored,
        extra).  Each tensor goes to ``device``, or to its template leaf's
        device when ``device`` is None.  An ``nn.Module`` template is
        restored in place (each parameter's ``.data`` rebound, so its type
        becomes the saved one) and returned; a dict is returned anew."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = _leaves(template)
        if len(leaves) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, template "
                f"has {len(leaves)}")
        names = [name for name, _ in leaves]
        if names != manifest["treedef"]:
            raise ValueError(f"checkpoint leaves {manifest['treedef']} are "
                             f"not the template's {names}")
        loaded = []
        for i, (_, leaf) in enumerate(leaves):
            arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
            if _checksum(arr) != manifest["checksums"][i]:
                raise IOError(f"checksum mismatch on leaf {i} (step {step})")
            if manifest["dtypes"][i] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            loaded.append(t.to(leaf.device if device is None else device))
        return _rebuild(template, iter(loaded)), manifest["extra"]


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of each leaf, in the fixed order."""
    if isinstance(tree, nn.Module):
        return [(prefix + n, p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("."), tree)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _rebuild(template: Any, loaded) -> Any:
    if isinstance(template, nn.Module):
        for p in template.parameters():
            t = next(loaded)
            if isinstance(p, DTensor):    # a meshed run's: its shard of t
                t = distribute_tensor(t, p.device_mesh, p.placements,
                                      src_data_rank=None)
            set_data(p, t)
        return template
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], loaded) for k in sorted(template)}
        return {k: out[k] for k in template}
    return next(loaded)


def _to_host(tree: Any) -> List[Tuple[str, np.ndarray, str]]:
    """A copy of each leaf in host memory: (name, array, type name)."""
    out = []
    for name, t in _leaves(tree):
        if isinstance(t, DTensor):      # a meshed run's: the whole tensor
            t = t.full_tensor()
        t = t.detach().to("cpu", copy=True)
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        out.append((name, arr, dtype))
    return out


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr)).hexdigest()[:16]
