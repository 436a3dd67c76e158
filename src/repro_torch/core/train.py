"""Training loop and batched inference for the predictor (in-repo AdamW).

Mirrors the reference ``repro.core.train``: the same batch order (the numpy
RNG of ``dataset.batches``), the same warmup-cosine schedule, AdamW with
weight decay 1e-4 and global-norm clipping at 1.0, the same fixed-shape
inference batches.  Init draws from a ``torch.Generator`` seeded with
``seed``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.dataset import SequenceDataset, batches
from repro_torch.core.families import PredictorConfig
from repro_torch.core.metrics import topk_accuracy, weighted_f1
from repro_torch.core.model import Predictor
from repro_torch.optimizer import AdamW, linear_warmup_cosine


@dataclasses.dataclass
class TrainResult:
    model: Predictor
    cfg: PredictorConfig
    metrics: Dict[str, float]
    steps: int
    train_seconds: float


def loss_fn(model: Predictor, x: torch.Tensor, y: torch.Tensor
            ) -> torch.Tensor:
    logp = torch.log_softmax(model(x), dim=-1)
    return -torch.gather(logp, 1, y.long()[:, None]).mean()


def train_predictor(cfg: PredictorConfig, data: SequenceDataset, *,
                    steps: int = 400, batch_size: int = 128,
                    lr: float = 3e-3, seed: int = 0,
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    eval_topk: int = 10, log_every: int = 0,
                    device: torch.device | str = "cuda") -> TrainResult:
    """Train from a seeded init, or from ``params`` (a ``Predictor`` state
    dict, e.g. ``convert.params_from_jax``)."""
    model = Predictor(cfg, torch.Generator().manual_seed(seed), device)
    if params is not None:
        model.load_state_dict(params)
    plist = list(model.parameters())
    opt = AdamW(weight_decay=1e-4, clip_norm=1.0)
    opt_state = opt.init(plist)
    sched = linear_warmup_cosine(lr, warmup_steps=min(50, steps // 10 + 1),
                                 total_steps=steps)

    t0 = time.time()
    it = batches(data.x_train, data.y_train, batch_size, seed=seed,
                 epochs=max(1, steps * batch_size // max(len(data.x_train), 1) + 1))
    n_done = 0
    for x, y in it:
        xb = torch.as_tensor(x, device=device)
        yb = torch.as_tensor(y, device=device)
        loss = loss_fn(model, xb, yb)
        # parameters the config leaves unused (wk under shared-QK HLSH, the
        # attention block under the bypass) get zero gradients, as in JAX
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            plist, torch.autograd.grad(loss, plist, allow_unused=True))]
        opt_state = opt.update(grads, plist, opt_state, sched(n_done))
        n_done += 1
        if log_every and n_done % log_every == 0:
            print(f"  step {n_done}/{steps} loss={float(loss):.4f}")
        if n_done >= steps:
            break
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    train_seconds = time.time() - t0

    metrics = evaluate(cfg, model, data, topk=eval_topk)
    return TrainResult(model=model, cfg=cfg, metrics=metrics,
                       steps=n_done, train_seconds=train_seconds)


def evaluate(cfg: PredictorConfig, model: Predictor, data: SequenceDataset,
             topk: int = 10, split: str = "test",
             batch_size: int = 512) -> Dict[str, float]:
    x = getattr(data, f"x_{split}")
    y = getattr(data, f"y_{split}")
    logits = predict_logits(cfg, model, x, batch_size)
    return {
        "top1": topk_accuracy(logits, y, 1),
        f"top{topk}": topk_accuracy(logits, y, topk),
        "f1": weighted_f1(logits, y),
        "n": float(len(y)),
    }


def _pad_batches(x: np.ndarray, batch_size: int):
    """Yield (batch, pad) pairs of fixed shape: every batch has exactly
    ``batch_size`` rows, as in the reference (rows are independent, so the
    padding changes no result)."""
    for i in range(0, len(x), batch_size):
        xb = x[i:i + batch_size]
        pad = 0
        if len(xb) < batch_size:
            pad = batch_size - len(xb)
            xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:],
                                              xb.dtype)])
        yield xb, pad


def _device_of(model: Predictor) -> torch.device:
    return model.head.device


@torch.no_grad()
def predict_logits(cfg: PredictorConfig, model: Predictor, x: np.ndarray,
                   batch_size: int = 512) -> np.ndarray:
    dev = _device_of(model)
    outs = []
    for xb, pad in _pad_batches(x, batch_size):
        o = model(torch.as_tensor(xb, device=dev)).cpu().numpy()
        outs.append(o[:batch_size - pad] if pad else o)
    return np.concatenate(outs)


@torch.no_grad()
def predict_cls_conf(cfg: PredictorConfig, model: Predictor, x: np.ndarray,
                     batch_size: int = 4096):
    """Top-1 class ids and their softmax probabilities for every row of
    ``x``: argmax and softmax run on the device and only two numbers per
    window come back to the host."""
    if len(x) == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32))
    dev = _device_of(model)
    cls_out, conf_out = [], []
    for xb, pad in _pad_batches(x, batch_size):
        logits = model(torch.as_tensor(xb, device=dev))
        c = torch.argmax(logits, dim=-1).cpu().numpy()
        p = torch.softmax(logits, dim=-1).max(dim=-1).values.cpu().numpy()
        if pad:
            c, p = c[:-pad], p[:-pad]
        cls_out.append(c)
        conf_out.append(p)
    return (np.concatenate(cls_out).astype(np.int64),
            np.concatenate(conf_out))
