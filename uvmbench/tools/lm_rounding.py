"""Where the rounding gap of the ``lm_train`` comparison's float32 steps
comes from, read at a cell's own size with the reference alone.

    python3 uvmbench/tools/lm_rounding.py --workload smollm-360m.train \\
        --seeds 11,12,13 [--out lm_rounding.jsonl]

Each seed prints one JSON line with three parts, each read at the
configuration's weights (``draw``) and again at the same draw with the
query, key and value projections scaled to a fan-in of ``d_model``
(``fan_in``), where the port's recipe takes their number of heads:

* ``look``: layer by layer, on the first sequence of step 0's batch and
  the drawn weights in float32 (what step 1 runs on, as step 0's rate is
  0): the rms of the residual stream entering the layer, the spread of
  the attention logits, the mean largest probability, the share of query
  heads whose largest probability is over 0.99 and whose two largest
  logits lie within 1e-3, the share whose largest key differs from the
  same forward in float64, and the norm of the loss's gradient at the
  layer's input;
* ``gaps``: the reference's set-up in blocks of two sequences, and in
  float64, against the reference in blocks of one: the comparison's
  numbers, the losses, the worst leaves, and each leaf's change gap
  grouped by the size of its first gradient over the median leaf's.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the first gradient over the median leaf's, by decade
BUCKETS = (1e-3, 1e-2, 1e-1, 1.0)


def fan_in_draw(config: Dict, device):
    """The configuration's draw with ``wq`` scaled to ``1/sqrt(d_model)``
    from ``1/sqrt(n_heads)``, ``wk`` and ``wv`` from ``1/sqrt(n_kv)``."""
    import torch
    from uvmbench.reference.lm import weights
    params = weights.draw(config, device)
    d = int(config["d_model"])
    heads = {"wq": int(config["n_heads"]), "wk": int(config["n_kv"]),
             "wv": int(config["n_kv"])}
    for k, v in params.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in heads and k.split(".")[-2] == "b0_attn":
            params[k] = (v.to(torch.float32)
                         * math.sqrt(heads[leaf] / d)).to(v.dtype)
    return params


def look(params: Dict, tokens, config: Dict) -> Dict[str, List[float]]:
    """The per-layer readings of the module's docstring."""
    import torch
    from uvmbench.reference.lm import model
    n = int(config["n_layers"])
    p32 = {k: v.float() for k, v in params.items()}
    p64 = {k: v.double() for k, v in params.items()}
    rows: Dict[str, List[float]] = {k: [] for k in (
        "rms_in", "logit_std", "top_prob", "saturated", "near_ties",
        "flips", "grad_in")}
    tops = []
    x = model.embed(p32, tokens, config).detach().requires_grad_(True)
    outs = [x]
    for i in range(n):
        with torch.no_grad():
            logits, _ = model.attention_logits(
                x, model.layer_params(p32, i, "b0_attn"), config)
            valid = logits > model.MASKED / 2
            rows["rms_in"].append(float(x.float().square().mean().sqrt()))
            rows["logit_std"].append(float(logits[valid].std()))
            top = torch.softmax(logits, -1).amax(-1)
            rows["top_prob"].append(float(top.mean()))
            rows["saturated"].append(float((top > 0.99).float().mean()))
            two = logits.topk(2, dim=-1).values
            rows["near_ties"].append(
                float(((two[..., 0] - two[..., 1]) < 1e-3).float().mean()))
            tops.append(logits.argmax(-1))
            del logits, valid, top, two
        x = model.layer(x, p32, i, config)
        outs.append(x)
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    loss32 = model.head_nll_sum(x, p32, tokens) / count
    grads = torch.autograd.grad(loss32, outs)
    rows["grad_in"] = [float(torch.linalg.vector_norm(g.float()))
                       for g in grads]
    del grads, outs, x
    with torch.no_grad():
        x = model.embed(p64, tokens, config)
        for i in range(n):
            logits, _ = model.attention_logits(
                x, model.layer_params(p64, i, "b0_attn"), config)
            rows["flips"].append(
                float((logits.argmax(-1) != tops[i]).float().mean()))
            del logits
            x = model.layer(x, p64, i, config)
        loss64 = model.head_nll_sum(x, p64, tokens) / count
    rows["loss_gap_f32_f64"] = [abs(float(loss32.detach()) - float(loss64))
                                / float(loss64)]
    return rows


def leaf_table(got: Dict, want: Dict) -> Dict:
    """``got``'s start against ``want``'s: the comparison's readings, the
    losses' gaps, and each leaf's change gap by the size of its first
    gradient (in ``want``) over the median leaf's."""
    from uvmbench.reference import lm_train as ref
    readings, info = ref.compare(got, want)
    first = want["first_grad_norms"]
    median = statistics.median(first.values())
    names = list(first)
    change = ref.leaf_gaps(got["change_norms"], want["change_norms"], names)
    grad = ref.leaf_gaps(got["first_grad_norms"], first, names)
    groups = []
    lo = 0.0
    for hi in (*BUCKETS, math.inf):
        keys = [k for k in names if lo <= first[k] / median < hi]
        if keys:
            gaps = sorted(change[k] for k in keys)
            groups.append({"first_over_median": [lo, hi],
                           "leaves": len(keys),
                           "change_gap_median": statistics.median(gaps),
                           "change_gap_max": gaps[-1],
                           "first_grad_gap_max": max(grad[k] for k in keys)})
        lo = hi
    worst = sorted(names, key=change.get, reverse=True)[:8]
    return {"readings": readings, "loss_gaps": info["loss_gaps"],
            "change_gap_all_median": statistics.median(change.values()),
            "groups": groups,
            "worst_change": [[k, change[k], first[k] / median, grad[k]]
                             for k in worst],
            "worst_first_grad": info["first_grad_worst_leaf"]}


def read_seed(config: Dict, traffic: Dict, seed: int, device: str) -> Dict:
    import torch
    from uvmbench.reference import lm_train as ref
    from uvmbench.reference.lm import weights
    out: Dict = {"seed": seed, "device": device}
    tokens = torch.from_numpy(ref._pipeline_at(config, traffic, seed, 0)
                              .next_batch()["tokens"][:1]).to(device).long()
    for name, draw in (("draw", weights.draw), ("fan_in", fan_in_draw)):
        t0 = time.perf_counter()
        part = {"look": look(draw(config, device), tokens, config)}
        if device == "cuda":
            torch.cuda.empty_cache()
        want = ref.replay(config, traffic, seed, device, draw=draw)
        part["gaps"] = {
            "block2": leaf_table(ref.replay(config, traffic, seed, device,
                                            block=2, draw=draw), want),
            "float64": leaf_table(ref.replay(config, traffic, seed, device,
                                             precision="float64", draw=draw),
                                  want)}
        part["seconds"] = time.perf_counter() - t0
        out[name] = part
        del want
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from uvmbench import spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    bench = spec.benchmark()
    cell = spec.workload(args.workload, bench)
    config = spec.config(cell["config"], bench)
    traffic = spec.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload,
                           **read_seed(config, traffic, seed, device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
