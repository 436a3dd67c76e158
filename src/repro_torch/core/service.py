"""Predictor service: the bridge between the trained model and the UVM
runtime (paper §7.1), ported from the reference ``repro.core.service``.

* ``fit`` trains the predictor on a trace (optionally from given params),
* ``predict_trace`` produces the per-access top-1 predicted page array the
  ``LearnedPrefetcher`` consumes: for every access i, the page the model
  expects ``distance`` requests later within i's cluster stream;
* ``pretrain_corpus`` pretrains one model on a corpus of several traces.

Training and inference run on ``device`` (default ``"cuda"``); on a CUDA
device the HLSH layer's inference goes through the K2 kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import families
from repro_torch.core.dataset import SEQ_LEN, build_dataset
from repro_torch.core.features import (ClusteredTrace, cluster_trace,
                                       delta_convergence)
from repro_torch.core.train import (TrainResult, predict_cls_conf,
                                    train_predictor)
from repro_torch.core.vocab import DeltaVocab, encode_features
from repro_torch.traces.trace import Trace


@dataclasses.dataclass
class PredictorService:
    """Owns a (simplified, by default) predictor for one benchmark.  The
    knobs and their defaults are the reference service's."""

    cluster_key: str = "sm"
    distance: int = 8
    min_prob: float = 0.35
    seq_len: int = SEQ_LEN
    steps: int = 300
    batch_size: int = 128
    quantize: bool = True
    bypass_threshold: float = 0.7
    seed: int = 0
    model_family: str = "simplified"
    device: str = "cuda"

    trace: Optional[Trace] = None
    ct: Optional[ClusteredTrace] = None
    vocab: Optional[DeltaVocab] = None
    result: Optional[TrainResult] = None
    convergence: float = 0.0

    @property
    def model_config(self) -> str:
        """Architecture digest of this service's family block, for cache
        keying; trace-determined parts are pinned to sentinels, as in the
        reference."""
        cfg = families.family_config(self.model_family, n_classes=0,
                                     convergence=0.0,
                                     bypass_threshold=self.bypass_threshold,
                                     quantize=self.quantize)
        return families.config_digest(cfg)

    def fit(self, trace: Trace,
            init_params: Optional[Dict[str, torch.Tensor]] = None,
            cfg: families.PredictorConfig | None = None,
            max_train: int = 16000) -> TrainResult:
        self.trace = trace
        self.ct = cluster_trace(trace, self.cluster_key)
        self.vocab = DeltaVocab.build(self.ct, distance=self.distance)
        self.convergence = delta_convergence(self.ct)
        if cfg is None:
            cfg = families.family_config(
                self.model_family, self.vocab.n_classes, self.convergence,
                self.bypass_threshold, quantize=self.quantize)
        data = build_dataset(self.ct, self.vocab, features=list(cfg.features),
                             seq_len=self.seq_len, distance=self.distance,
                             max_train=max_train, seed=self.seed)
        self.result = train_predictor(cfg, data, steps=self.steps,
                                      batch_size=self.batch_size,
                                      seed=self.seed, params=init_params,
                                      device=self.device)
        return self.result

    def predict_trace(self, trace: Trace | None = None,
                      batch_size: int = 4096) -> np.ndarray:
        """Per-access predicted pages, aligned with GMMU trace order: entry
        i is the top-1 page expected ``distance`` accesses after i in i's
        cluster, or -1 where no prediction is available (window warmup, UNK
        class, or confidence below ``min_prob``).  Windows of all clusters
        are concatenated and inferred in fixed-size batches, flushed every
        ``max(batch_size, 65536)`` windows."""
        if self.result is None or self.vocab is None:
            raise RuntimeError("predict_trace before fit")
        if trace is None:
            ct = self.ct
        else:
            ct = cluster_trace(trace, self.cluster_key)
        cfg, model = self.result.cfg, self.result.model
        out = np.full(max(g.max() for g in ct.global_index) + 1, -1,
                      dtype=np.int64)
        window = np.arange(self.seq_len)[None, :]
        flush_windows = max(batch_size, 65536)
        pend_x: list = []
        pend_spans: list = []
        pend_n = 0

        def _flush() -> None:
            nonlocal pend_x, pend_spans, pend_n
            if not pend_x:
                return
            x = pend_x[0] if len(pend_x) == 1 else np.concatenate(pend_x)
            cls, conf = predict_cls_conf(cfg, model, x, batch_size)
            off = 0
            for pages, gidx, ends in pend_spans:
                m = len(ends)
                c, p = cls[off:off + m], conf[off:off + m]
                off += m
                deltas = self.vocab.decode(c)
                # confidence gate: no prefetch on low-probability
                # predictions (useless prefetches cost bus bandwidth, §7.6)
                pred_pages = np.where((c == 0) | (p < self.min_prob),
                                      -1, pages[ends] + deltas)
                out[gidx[ends]] = pred_pages
            pend_x, pend_spans, pend_n = [], [], 0

        for cluster, pages, gidx in zip(ct.clusters, ct.pages,
                                        ct.global_index):
            n = len(pages)
            if n < self.seq_len:
                continue
            enc = encode_features(cluster, list(cfg.features))
            all_starts = np.arange(0, n - self.seq_len + 1)
            for s0 in range(0, len(all_starts), flush_windows):
                starts = all_starts[s0:s0 + flush_windows]
                pend_x.append(enc[starts[:, None] + window])
                pend_spans.append((pages, gidx, starts + self.seq_len - 1))
                pend_n += len(starts)
                if pend_n >= flush_windows:
                    _flush()
        _flush()
        return out


def pretrain_corpus(traces: List[Trace], cfg: families.PredictorConfig,
                    vocab: DeltaVocab, cluster_key: str = "sm_warp",
                    distance: int = 30, steps: int = 300, seed: int = 0,
                    device: str = "cuda") -> Dict[str, torch.Tensor]:
    """Paper §7.1: build a corpus from several benchmarks (the leading 50%
    of each) and pretrain a single model on it; returns the trained
    ``Predictor``'s state dict.  The shared vocab must be built by the
    caller over the union of the traces."""
    xs, ys = [], []
    for tr in traces:
        half, _ = tr.split(0.5)
        ct = cluster_trace(half, cluster_key)
        data = build_dataset(ct, vocab, features=list(cfg.features),
                             distance=distance, max_train=8000, seed=seed)
        xs.append(data.x_train)
        ys.append(data.y_train)
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    # the last trace's dataset container, holding the corpus
    ds = dataclasses.replace(
        data, x_train=x, y_train=y, x_valid=x[:256], y_valid=y[:256],
        x_test=x[:256], y_test=y[:256])
    res = train_predictor(cfg, ds, steps=steps, seed=seed, device=device)
    return res.model.state_dict()
