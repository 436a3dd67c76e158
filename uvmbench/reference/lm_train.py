"""The plain reference of the ``lm_train`` driver, and the comparison that
decides a run's ``correct``.

At the configuration's weights the float32 steps are chaotic, and
``tools/lm_rounding.py`` shows why: the recipe draws the query, key and
value projections over their number of heads, so attention is one-hot
(logits spread ~110) and a query's choice of key flips wherever two
logits tie to rounding; a flip moves a whole value row and flips later
layers' choices, until float32 and float64 forwards of the same step
pick different keys at most query heads of the upper layers.  The loss's
gradient grows layer by layer downward, so the lower layers' leaves take
that noise: rounding alone (the reference against itself in blocks of
one and of two sequences, or in float64) moves a float32 step's loss by
1e-4 to 1e-3 and the worst leaf's change over the set-up by a tenth or
more, as much as the controls do.  So the check has two parts.

The start (:func:`replay`): the reference draws the weights
(``lm.weights``) and makes the run's token stream (``lm.pipeline``)
itself and takes the mix's ``setup_steps`` training steps, each a loss
and gradient over the batch (``lm.model``) in blocks of sequences,
accumulated in float32, then AdamW (``lm.optim``).  Against the program's
set-up it reads ``loss_gap_bf16_step`` (step 0's loss, on the bf16
weights of the draw, where rounding agrees), ``first_grad_gap`` (each
leaf's first gradient, worked out from AdamW's first moments after step
0: by the worst leaf, the gap of the two sides' norms over the
reference's norm of that leaf or of the median leaf, whichever is
larger) and ``change_gap_median`` (the median over every leaf of the
same gap of each leaf's change over the set-up).  The float32 losses and
the worst leaf's change are reported beside them and not compared.

The held step (:func:`held_readings`): after the window the program
takes one more float32 step through the same call, and keeps each
layer's input, the last layer's output, the loss's gradient at each,
every leaf's gradient, the loss, and its state before and after the
update.  The reference follows that step from the program's own state,
layer by layer on the step's own inputs, where rounding does not
compound: the embedding of its own tokens, each layer's output and its
backward, the head's backward, and AdamW's update.

It runs in float32 with TF32 off, after the program's state is freed, on
the device the program ran on.  ``mismatches`` counts facts that must hold
and do not (the leaves' names, the number of losses, the held step's
layout).  A reading that is not finite reads ``BIG``.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from uvmbench.reference.lm import model, optim, pipeline, weights

#: where a reading is not finite
BIG = 1e9
#: the precisions the reference can run its float32 steps in: its own,
#: the controls one step below it, and float64 (the parameters float64
#: from step 0's update on: the float32 steps without their rounding)
PRECISIONS = ("float32", "tf32", "bf16", "float64")


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _autocast(device: torch.device, precision: str):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=precision == "bf16")


def loss_and_grads(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   config: Dict, block: int, precision: str
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The mean next-token loss of ``tokens`` and its gradient, in blocks
    of ``block`` sequences, the gradient accumulated in float32 (float64
    for float64 leaves) and given each leaf's type."""
    device = tokens.device
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    acc = {k: model.wide(torch.zeros(v.shape, dtype=v.dtype, device=device))
           for k, v in params.items()}
    total = torch.zeros((), dtype=acc["embed"].dtype, device=device)
    for lo in range(0, tokens.shape[0], block):
        with _autocast(device, precision):
            part = model.nll_sum(leaves, tokens[lo:lo + block], config)
        grads = torch.autograd.grad(part / count, list(leaves.values()))
        for k, g in zip(leaves, grads):
            acc[k] += g
        total += part.detach()
    return (float(total / count),
            {k: acc[k].to(params[k].dtype) for k in params})


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
               ) -> Dict[str, float]:
    norms = torch.stack([torch.linalg.vector_norm(t.float())
                         for t in tensors.values()]) * scale
    return dict(zip(tensors, norms.tolist()))


def _pipeline_at(config: Dict, traffic: Dict, seed: int, step: int):
    pipe = pipeline.TokenPipeline(int(config["vocab"]),
                                  int(traffic["seq_len"]),
                                  int(traffic["batch"]), seed=seed % 2 ** 32)
    pipe.step = step
    return pipe


def _optimizer(config: Dict) -> optim.AdamW:
    a = config["adamw"]
    return optim.AdamW(a["b1"], a["b2"], a["eps"], a["weight_decay"],
                       a["clip_norm"])


def _schedule(traffic: Dict):
    return optim.linear_warmup_cosine(float(traffic["lr"]),
                                      int(traffic["warmup"]),
                                      int(traffic["schedule_steps"]))


def hold_step(params: Dict[str, torch.Tensor], state: optim.State,
              tokens: torch.Tensor, step: int, config: Dict, traffic: Dict,
              block: int = 1, precision: str = "float32") -> Dict:
    """One training step of the reference, laid out as the program's held
    step (``Program.traces()["held"]``): each layer's input and the last
    layer's output (``xs``), the loss's gradient at each (``gs``), the
    loss, every leaf's gradient, and the parameters and moments before and
    the parameters after the update."""
    n = int(config["n_layers"])
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    before = {"params": {k: v.clone() for k, v in params.items()},
              "mu": {k: v.clone() for k, v in state.mu.items()},
              "nu": {k: v.clone() for k, v in state.nu.items()},
              "opt_step": state.step}
    xs: List[Optional[torch.Tensor]] = [None] * (n + 1)
    gs: List[Optional[torch.Tensor]] = [None] * (n + 1)
    acc = {k: model.wide(torch.zeros(v.shape, dtype=v.dtype,
                                     device=v.device))
           for k, v in params.items()}
    total = 0.0
    device = tokens.device
    for lo in range(0, tokens.shape[0], block):
        hi = min(lo + block, tokens.shape[0])
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with _autocast(device, precision):
            x = model.embed(leaves, tokens[lo:hi], config)
            outs = [x]
            for index in range(n):
                x = model.layer(x, leaves, index, config)
                outs.append(x)
            part = model.head_nll_sum(x, leaves, tokens[lo:hi])
        got = torch.autograd.grad(part / count, list(leaves.values()) + outs)
        for k, g in zip(leaves, got):
            acc[k] += g
        for i, (o, g) in enumerate(zip(outs, got[len(leaves):])):
            if xs[i] is None:
                xs[i] = torch.empty((tokens.shape[0], *o.shape[1:]),
                                    dtype=o.dtype, device=device)
                gs[i] = torch.empty_like(xs[i])
            xs[i][lo:hi] = o.detach()
            gs[i][lo:hi] = g
        total += float(part.detach())
    grads = {k: acc[k].to(params[k].dtype) for k in params}
    state = _optimizer(config).update(grads, params, state,
                                      _schedule(traffic)(step))
    return {"step": step, "xs": xs, "gs": gs, "loss": total / count,
            "grads": grads, "before": before, "after": {"params": params}}


#: the held step's numbers
HELD_NUMBERS = ("embed_gap", "block_out_gap", "block_grad_gap",
                "update_gap")


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


@torch.no_grad()
def _update_gap(held: Dict, config: Dict, traffic: Dict) -> float:
    """AdamW from the held step's state before and its gradients, against
    the parameters after: by the worst leaf, the gap over the reference's
    change of that leaf or of the median leaf, whichever is larger."""
    b = held["before"]
    params = {k: v.clone() for k, v in b["params"].items()}
    state = optim.State(int(b["opt_step"]), dict(b["mu"]), dict(b["nu"]))
    _optimizer(config).update(dict(held["grads"]), params, state,
                              _schedule(traffic)(int(held["step"])))
    moved = {k: _norm(params[k] - b["params"][k]) for k in params}
    gaps = {k: _norm(held["after"]["params"][k] - params[k]) for k in params}
    median = statistics.median(moved.values())
    return max(_fin(gaps[k] / max(moved[k], median)) for k in params)


def _worst(gaps: Dict[str, float]) -> List:
    worst = max(gaps, key=gaps.get)
    return [worst, gaps[worst]]


def _fin(x: float) -> float:
    return x if np.isfinite(x) else BIG


def held_readings(held: Dict, config: Dict, traffic: Dict, seed: int,
                  device) -> Tuple[Dict[str, float], Dict]:
    """The held step, layer by layer on the step's own inputs: the first
    layer's input against the embedding of the reference's own tokens;
    each layer's output against the reference's layer on the same input
    (the gap over the layer's own contribution, ``out - in``, by the worst
    layer); the gradients of the inputs and of every leaf against the
    reference's backward of each layer (and of the head and the embedding)
    given the same gradient at its output (the gap over the reference's
    norm of that leaf or of the median leaf, by the worst); and the
    update (:func:`_update_gap`).  The loss against the reference's head
    on the last layer's output goes to the information, not compared."""
    device = torch.device(device)
    n = int(config["n_layers"])
    want_shape = (int(traffic["batch"]), int(traffic["seq_len"]),
                  int(config["d_model"]))
    params = held["before"]["params"]
    xs, gs = held["xs"], held["gs"]
    mismatches = int(len(xs) != n + 1 or len(gs) != n + 1
                     or set(held["grads"]) != set(params)
                     or any(t is None or tuple(t.shape) != want_shape
                            for t in xs + gs))
    if mismatches:
        return ({"mismatches": 1, **dict.fromkeys(HELD_NUMBERS, BIG)},
                {"held_why": "the held step's layout is not the cell's"})
    tokens = torch.from_numpy(_pipeline_at(config, traffic, seed,
                                           int(held["step"]))
                              .next_batch()["tokens"]).to(device).long()
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    ref_grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=device)
                 for k, v in params.items()}
    out_gap = [[0.0, 0.0] for _ in range(n)]
    dx_gap = {i: [0.0, 0.0] for i in range(n + 1)}
    loss = 0.0
    with torch.no_grad():
        x0 = model.embed(params, tokens, config)
        embed_gap = _fin(_norm(xs[0] - x0) / _norm(x0))
    for lo in range(0, tokens.shape[0]):
        rows = slice(lo, lo + 1)
        for i in range(n):
            prefix = f"segments.0.{i}."
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items() if k.startswith(prefix)}
            x = xs[i][rows].detach().requires_grad_(True)
            out = model.layer(x, leaves, i, config)
            got = torch.autograd.grad(out, [x, *leaves.values()],
                                      grad_outputs=gs[i + 1][rows])
            with torch.no_grad():
                out_gap[i][0] += _norm(out - xs[i + 1][rows]) ** 2
                out_gap[i][1] += _norm(out - x) ** 2
                dx_gap[i][0] += _norm(got[0] - gs[i][rows]) ** 2
                dx_gap[i][1] += _norm(got[0]) ** 2
                for k, g in zip(leaves, got[1:]):
                    ref_grads[k] += g.float()
        head = {k: params[k].detach().requires_grad_(True)
                for k in ("final_ln", "embed")}
        x = xs[n][rows].detach().requires_grad_(True)
        part = model.head_nll_sum(x, head, tokens[rows])
        got = torch.autograd.grad(part / count, [x, *head.values()])
        loss += float(part.detach())
        with torch.no_grad():
            dx_gap[n][0] += _norm(got[0] - gs[n][rows]) ** 2
            dx_gap[n][1] += _norm(got[0]) ** 2
            for k, g in zip(head, got[1:]):
                ref_grads[k] += g.float()
    # the embedding's rows as the first layer's input, given its gradient
    table = params["embed"].detach().requires_grad_(True)
    (g_table,) = torch.autograd.grad(
        model.embed({"embed": table}, tokens, config), [table],
        grad_outputs=gs[0])
    ref_grads["embed"] += g_table.float()
    loss /= count
    norms = {k: _norm(g) for k, g in ref_grads.items()}
    median = statistics.median(norms.values())
    grad_gaps = {k: _fin(_norm(held["grads"][k].float() - ref_grads[k])
                         / max(norms[k], median)) for k in params}
    dx = {f"dx.{i}": _fin((a / max(b, 1e-300)) ** 0.5)
          for i, (a, b) in dx_gap.items()}
    readings = {
        "mismatches": 0,
        "embed_gap": embed_gap,
        "block_out_gap": max(_fin((a / max(b, 1e-300)) ** 0.5)
                             for a, b in out_gap),
        "block_grad_gap": max(max(grad_gaps.values()), max(dx.values())),
        "update_gap": _update_gap(held, config, traffic),
    }
    info = {"held_step": int(held["step"]),
            # reported, not compared: no control or fault reads ten times
            # the sound runs' gap
            "head_loss_gap": _rel(float(held["loss"]), loss),
            "held_worst_leaf": _worst(grad_gaps),
            "held_dx_gaps": dx}
    return readings, info


def _rel(a: float, b: float) -> float:
    return _fin(abs(a - b) / abs(b) if b else abs(a - b))


def leaf_gaps(ours: Dict[str, float], theirs: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    median = statistics.median(theirs.values())
    return {k: _fin(abs(ours[k] - theirs[k]) / max(theirs[k], median))
            for k in leaves}


#: the start's numbers
START_NUMBERS = ("loss_gap_bf16_step", "first_grad_gap", "change_gap_median")


def compare(got: Dict, want: Dict) -> Tuple[Dict[str, float], Dict]:
    """The start's readings of ``got`` (the program's set-up, or a
    stand-in's, as :func:`replay` lays it out) against ``want`` (the
    reference's)."""
    names = list(want["first_grad_norms"])
    mismatches = sum(set(got[key]) != set(names)
                     for key in ("first_grad_norms", "change_norms"))
    mismatches += len(got["losses"]) != len(want["losses"])
    if mismatches:
        return ({"mismatches": mismatches,
                 **dict.fromkeys(START_NUMBERS, BIG)},
                {"why": "the leaves or the losses do not line up"})
    gaps = [_rel(a, b) for a, b in zip(got["losses"], want["losses"])]
    first = want["first_grad_norms"]
    change = leaf_gaps(got["change_norms"], want["change_norms"], names)
    grad = leaf_gaps(got["first_grad_norms"], first, names)
    readings = {
        "mismatches": 0,
        "loss_gap_bf16_step": gaps[0],
        "first_grad_gap": max(grad.values()),
        "change_gap_median": statistics.median(change.values()),
    }
    info = {"loss_gaps": gaps,
            "first_grad_worst_leaf": _worst(grad),
            "change_worst_leaf": _worst(change), "leaves": len(names)}
    return readings, info


def judge(got: Dict, want: Dict, config: Dict, traffic: Dict, seed: int,
          device) -> Tuple[Dict[str, float], Dict]:
    """Every reading of a run (``got``: the start's and the held step's)
    against the reference's start (``want``), and what the check found
    (``rows_failed``: of the checked steps, step 0, the set-up's last and
    the held step, those that missed)."""
    start, info = compare(got, want)
    held, held_info = held_readings(got["held"], config, traffic, seed,
                                    device)
    readings = {**start, **held,
                "mismatches": start["mismatches"] + held["mismatches"]}
    limits = config["limits"]

    def over(*keys):
        return any(readings[k] > limits[k] for k in keys)
    info.update(held_info)
    info["rows_failed"] = sum((
        over("loss_gap_bf16_step", "first_grad_gap"),
        over("change_gap_median"),
        over("mismatches", *HELD_NUMBERS)))
    return readings, info


def replay(config: Dict, traffic: Dict, seed: int, device,
           precision: str = "float32", block: int = 1,
           hold: bool = False, draw=weights.draw) -> Dict:
    """The reference's run: ``{"losses": [set-up's steps...],
    "first_grad_norms", "change_norms"}`` by leaf, as the program's set-up
    reports them; with ``hold``, also ``held``, a step taken after them as
    the program's held step is (for a stand-in in the program's place).
    ``draw(config, device)`` draws the weights (the port's recipe)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    device = torch.device(device)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _set_tf32(precision == "tf32")
    try:
        return _replay(config, traffic, seed, device, precision, block, hold,
                       draw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def _replay(config, traffic, seed, device, precision, block, hold,
            draw) -> Dict:
    params = draw(config, device)
    pipe = _pipeline_at(config, traffic, seed, 0)
    a = config["adamw"]
    opt = _optimizer(config)
    lr_fn = _schedule(traffic)
    state = opt.init(params)

    def batch():
        return torch.from_numpy(pipe.next_batch()["tokens"]).to(
            device).long()

    losses: List[float] = []
    first: Dict[str, float] = {}
    for step in range(int(traffic["setup_steps"])):
        loss, grads = loss_and_grads(params, batch(), config, block,
                                     precision)
        losses.append(loss)
        state = opt.update(grads, params, state, lr_fn(step))
        del grads
        if step == 0:
            first = leaf_norms(state.mu, 1.0 / (1.0 - a["b1"]))
            if precision == "float64":
                # the moments keep their type: step 1 meets them as the
                # program does (bf16, scaled by bf16 rates)
                params.update({k: v.double() for k, v in params.items()})
    drawn = draw(config, device)
    change = leaf_norms({k: model.wide(params[k]) - drawn[k].to(
        model.wide(params[k]).dtype) for k in params})
    del drawn
    out = {"losses": losses, "first_grad_norms": first,
           "change_norms": change}
    if hold:
        out["held"] = hold_step(params, state, batch(), pipe.step - 1,
                                config, traffic, block, precision)
    return out


def program_run(traces: Dict) -> Dict:
    """What the program's run produced, as :func:`replay` lays it out: its
    set-up's readings and the held step."""
    return {"losses": list(traces["setup_losses"]),
            "first_grad_norms": traces["first_grad_norms"],
            "change_norms": traces["change_norms"], "held": traces["held"]}


def check(config: Dict, traffic: Dict, seed: int,
          passes: Sequence[List[Dict]], traces: Dict,
          workers: Optional[int] = None) -> Tuple[Dict[str, float], Dict]:
    """The readings of the program's run against the reference, on the
    device the program ran on (``traces["device"]``), and what the check
    found.  ``passes`` (the window's rows) are checked by
    ``Program.window_checks``; ``workers`` is not used: the reference runs
    on the device."""
    t0 = time.perf_counter()
    want = replay(config, traffic, seed, traces["device"])
    readings, info = judge(program_run(traces), want,
                           config, traffic, seed, traces["device"])
    info["reference_s"] = time.perf_counter() - t0
    return readings, info
