"""The controls and the planted faults of the ``lm_train`` comparison,
read at a cell's own size, and the program's sound readings beside them.

    python3 uvmbench/tools/lm_control.py --workload smollm-360m.train \\
        --seeds 11,12,13 --variants program,tf32,bf16,half_batch,token \\
        [--out lm_control.jsonl]

Variants:

* ``program``: a run of the cell as the benchmark makes it (the look for
  a card skipped; a window of one step), its readings sound;
* ``tf32``, ``bf16``: the controls, the reference put in the program's
  place (its start and a held step) one precision below the
  configuration's: TF32 matmuls, or a bf16 autocast of every forward;
  ``block2``: the reference in blocks of two sequences, rounding alone;
* the faults in :data:`FAULTS`, planted in the program, each a run of
  the cell as ``program`` is.

Each (seed, variant) prints one JSON line: the readings, the limits and
the numbers that reject it.  It runs on the card where there is one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def patched(owner, attr: str, make: Callable) -> Iterator[None]:
    """``owner.attr`` replaced by ``make(original)`` for the context."""
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def state_unchanged():
    """The step returns its parameters and optimizer state unchanged."""
    from repro_torch.optimizer import AdamW
    return patched(AdamW, "update",
                   lambda f: lambda self, grads, params, state, lr: state)


def _adamw_with(**changes):
    from repro_torch.optimizer import AdamW
    return patched(AdamW, "update", lambda f: lambda self, *a, **kw: f(
        dataclasses.replace(self, **changes), *a, **kw))


def no_weight_decay():
    """AdamW without its weight decay."""
    return _adamw_with(weight_decay=0.0)


def clipping_skipped():
    """AdamW without its global-norm clipping."""
    return _adamw_with(clip_norm=None)


def lr_shifted():
    """The schedule read one step late."""
    from repro_torch import optimizer
    return patched(optimizer, "linear_warmup_cosine",
                   lambda f: lambda *a, **kw: (
                       lambda lr: lambda step: lr(step + 1))(f(*a, **kw)))


def half_batch():
    """Half of the batch left out, the loss the mean over the rest."""
    from repro_torch.launch import train
    return patched(train, "train_loss", lambda f: lambda m, p, batch, **kw: f(
        m, p, {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()},
        **kw))


def token():
    """One token altered where the pipeline produces it."""
    from repro_torch.data import TokenPipeline

    def make(f):
        def next_batch(self):
            out = f(self)
            toks = out["tokens"].copy()
            toks[0, toks.shape[1] // 2] = (toks[0, toks.shape[1] // 2] + 1) \
                % self.vocab
            return {**out, "tokens": toks}
        return next_batch
    return patched(TokenPipeline, "next_batch", make)


def bf16_matmuls():
    """The loss and its gradient under a bf16 autocast: every product in
    bf16."""
    import torch
    from repro_torch.launch import train

    def make(f):
        def train_loss(model, params, batch, **kw):
            device = next(iter(batch.values())).device.type
            with torch.autocast(device, dtype=torch.bfloat16):
                return f(model, params, batch, **kw)
        return train_loss
    return patched(train, "train_loss", make)


def layer_dropped():
    """The first layer's MLP block returns its input: that layer's MLP
    output dropped."""
    from repro_torch.models import layers
    first: List = []

    def make(f):
        def swiglu_block(x, p):
            if not first:
                first.append(p["ln"])
            return x if p["ln"] is first[0] else f(x, p)
        return swiglu_block
    return patched(layers, "swiglu_block", make)


#: faults planted in the program, by name
FAULTS: Dict[str, Callable] = {
    "state_unchanged": state_unchanged, "half_batch": half_batch,
    "token": token, "no_weight_decay": no_weight_decay,
    "clipping_skipped": clipping_skipped, "lr_shifted": lr_shifted,
    "bf16_matmuls": bf16_matmuls, "layer_dropped": layer_dropped,
}
#: the reference in the program's place: (precision, block)
STAND_INS = {"tf32": ("tf32", 1), "bf16": ("bf16", 1),
             "block2": ("float32", 2)}


def run_program(name: str, seed: int, seconds: float, device: str, *,
                bench=None, config=None, traffic=None, fault=None) -> Dict:
    """A run of cell ``name`` (with ``fault`` planted); its result."""
    from uvmbench import harness
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        result, _ = harness.run_cell(
            name, seed, seconds, False, device=device,
            t_start=time.perf_counter(), bench=bench, config=config,
            traffic=traffic)
    return result


def stand_in_readings(config: Dict, traffic: Dict, seed: int, device: str,
                      variant: str, want: Optional[Dict] = None) -> Dict:
    """The comparison's readings of the reference run as ``variant`` in the
    program's place (its start and a held step); ``want`` is the float32
    reference's start (made here when not given)."""
    from uvmbench.reference import lm_train as ref
    precision, block = STAND_INS[variant]
    if want is None:
        want = ref.replay(config, traffic, seed, device)
    got = ref.replay(config, traffic, seed, device, precision, block,
                     hold=True)
    readings, info = ref.judge(got, want, config, traffic, seed, device)
    return {"readings": readings, "info": info}


def main(argv: Optional[List[str]] = None) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from uvmbench import spec
    from uvmbench.reference import lm_train as ref
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,tf32,bf16")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="the window of a program or fault run")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    bench = spec.benchmark()
    cell = spec.workload(args.workload, bench)
    config = spec.config(cell["config"], bench)
    traffic = spec.traffic(cell["traffic"])
    limits = config["limits"]
    variants = args.variants.split(",")
    for v in variants:
        if v not in ("program", *STAND_INS, *FAULTS):
            ap.error(f"unknown variant {v!r}")
    for seed in (int(s) for s in args.seeds.split(",")):
        want = None
        for v in variants:
            t0 = time.perf_counter()
            if v in STAND_INS:
                if want is None:
                    want = ref.replay(config, traffic, seed, device)
                out = stand_in_readings(config, traffic, seed, device, v,
                                        want)
                readings = out["readings"]
            else:
                out = run_program(args.workload, seed, args.seconds, device,
                                  fault=None if v == "program" else v)
                readings = {k: c["value"] for k, c in out["checks"].items()}
            line = {"workload": args.workload, "seed": seed, "variant": v,
                    "device": device, "readings": readings,
                    "rejected_by": [k for k, x in readings.items()
                                    if x > limits[k]],
                    "seconds": time.perf_counter() - t0, "detail": out}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
