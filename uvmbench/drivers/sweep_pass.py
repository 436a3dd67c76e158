"""Drive the window with whole passes of one researcher's sweep.

A configuration names the benches, scale, trace window and the seed of
its traces; a traffic mix names the capacity ratios, eviction policies,
capacity splits and prefetchers.  Their product is the sweep's grid, in an
order drawn from ``--seed`` (:func:`grid`).  Each pass calls the program's
entry, ``repro_torch.uvm.sweep.run_sweep``, on the whole grid with no
``out_dir`` and no ``cache_dir``, so nothing is written to disk and every
pass replays every cell.

The traces' seed is the configuration's, not ``--seed``: the replays' work
depends on each trace's eviction dynamics, and traces of another seed cost
the card some percent more or less, which would widen every bound.  Every
``--seed`` replays the same cells, in its own order.

Set-up builds (or finds built) K1 in the program's build directory inside
the checkout, generates the grid's traces (the sweep keeps them in its
in-process trace memo), and runs one whole pass as a warm-up: every K1
kind runs, and the host's allocator has grown to a pass's arrays, before
the window.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Sequence

import numpy as np

#: row fields that measure the host, not the simulation
VOLATILE_FIELDS = ("seconds", "train_seconds", "predict_seconds")


#: salt of the stream that orders the grid
ORDER_SALT = 0x0D3E


def grid(config: Dict, traffic: Dict, seed: int) -> List[Dict]:
    """The sweep's cells as plain dicts: the product of the axes (benches,
    ratios, evictions, splits, prefetchers, the last fastest) in the order
    of ``numpy.random.default_rng([seed mod 2**64, ORDER_SALT])``."""
    cells = [dict(bench=bench, prefetcher=pf, scale=float(config["scale"]),
                  seed=int(config["trace_seed"]), window=config["window"],
                  device_frac=float(ratio), eviction=eviction,
                  capacity_split=split)
             for bench in config["benches"]
             for ratio in traffic["ratios"]
             for eviction in traffic["evictions"]
             for split in traffic["capacity_splits"]
             for pf in traffic["prefetchers"]]
    order = np.random.default_rng([int(seed) % 2 ** 64,
                                   ORDER_SALT]).permutation(
        len(cells))
    return [cells[i] for i in order]


def pages_digest(pages: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(pages, dtype=np.int64).tobytes()).hexdigest()


class Program:
    """The system under test, set up for one cell."""

    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: str) -> None:
        import torch
        from repro_torch import kernels
        from repro_torch.uvm import sweep
        self.torch, self.kernels, self.sweep = torch, kernels, sweep
        self.device = device
        self.setup_s: Dict[str, float] = {}
        self.launches: List[int] = []
        self.cells = [sweep.SweepCell(**spec)
                      for spec in grid(config, traffic, seed)]

        t = time.perf_counter()
        if device == "cuda":
            from repro_torch.kernels import build
            build.build(["lane_replay"])
            torch.cuda.init()
        self.setup_s["k1_build"] = time.perf_counter() - t

        t = time.perf_counter()
        self.benches = list(dict.fromkeys(c.bench for c in self.cells))
        for bench in self.benches:
            self._trace(bench)
        self.setup_s["traces"] = time.perf_counter() - t

        t = time.perf_counter()
        sweep.run_sweep(self.cells, device=device)
        self._sync()
        self.setup_s["warmup"] = time.perf_counter() - t

    def _sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def _trace(self, bench: str):
        cell = self.cells[0]
        return self.sweep.load_trace(bench, cell.scale, cell.seed,
                                     cell.window)

    def _k1_launches(self) -> int:
        return self.kernels.launch_counts()["lane_replay"]

    def run_pass(self) -> List[Dict]:
        """One whole pass of the grid; returns its rows."""
        before = self._k1_launches()
        rows = self.sweep.run_sweep(self.cells, device=self.device)
        self._sync()
        self.launches.append(self._k1_launches() - before)
        return rows

    def counters(self) -> Dict:
        return {"k1_launches": list(self.launches)}

    def traces(self) -> Dict[str, Dict]:
        """The traces the window replayed, as the reference compares them."""
        out = {}
        for bench in self.benches:
            trace = self._trace(bench)
            out[bench] = {"n_accesses": int(len(trace.pages)),
                          "n_instructions": int(trace.n_instructions),
                          "sha256": pages_digest(trace.pages)}
        return out

    def window_checks(self, passes: Sequence[List[Dict]]) -> Dict[str, int]:
        """Checks of the window's own rows: every pass returns a row per
        cell, every row ran on K1, every pass equals the first and launches
        K1 as often (the first at least once on the card)."""
        n = len(self.cells)
        first = passes[0] if passes else []
        missing = sum(abs(n - len(rows)) for rows in passes)
        non_cuda = sum(1 for rows in passes for r in rows
                       if r.get("backend") != "cuda")
        diffs = 0
        for rows in passes[1:]:
            for a, b in zip(first, rows):
                if _stable(a) != _stable(b):
                    diffs += 1
        launches = self.launches
        launch_diffs = sum(1 for k in launches[1:] if k != launches[0])
        if self.device == "cuda" and launches and launches[0] == 0:
            launch_diffs += 1
        return {"rows_missing": missing, "non_cuda_rows": non_cuda,
                "pass_row_diffs": diffs, "k1_launch_diffs": launch_diffs}

    def span_targets(self):
        """The program's functions the traced run wraps in spans."""
        from repro_torch.uvm.backends import cuda_backend
        sweep = self.sweep
        backend = cuda_backend.CudaReplayBackend
        return [
            (sweep, "resolve_evictions", "sweep.resolve_evictions"),
            (sweep, "prepare_cell", "sweep.prepare_cell"),
            (sweep, "_solo_requests", "sweep._solo_requests"),
            (sweep, "_finish_row", "sweep._finish_row"),
            (sweep, "_mt_row", "sweep._mt_row"),
            (backend, "can_replay", "cuda_backend.can_replay"),
            (backend, "pack_lanes", "cuda_backend.pack_lanes"),
            (backend, "_replay_batch", "cuda_backend._replay_batch"),
            (backend, "pack_batch", "cuda_backend.pack_batch"),
            (cuda_backend, "lane_replay", "kernels.lane_replay"),
        ]

    def close(self) -> None:
        """Free the program's state before the reference runs."""
        self.sweep._trace_memo.clear()
        self.cells = []
        if self.device == "cuda":
            self.torch.cuda.empty_cache()


def _stable(row: Dict) -> Dict:
    return {k: v for k, v in row.items() if k not in VOLATILE_FIELDS}


#: what :func:`work` counts
WORK_UNIT = "accesses"


def work(rows: Sequence[Dict]) -> int:
    """The simulated accesses of ``rows`` (the window's work)."""
    return sum(int(r["n_accesses"]) for r in rows)


def end_to_end(rows: Sequence[Dict], window_s: float) -> Dict[str, float]:
    """The window's end-to-end metrics but set-up: every simulated access
    the window finished over all of its time."""
    return {"sim_accesses_per_s": work(rows) / window_s}
