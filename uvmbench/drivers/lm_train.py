"""Drive the window with training steps of one language model, closed loop:
each step starts when the last has finished, as one trainer's job runs.

The program is set up as ``repro_torch.launch.train.train`` sets it up,
from its own public functions: ``build_model`` of the registry's
architecture (with the configuration's widths, which a test holds equal
to the registry's, and the mix's ``remat``), ``TokenPipeline`` seeded by
``--seed``, ``AdamW`` with the configuration's decay and clipping,
``linear_warmup_cosine`` of the mix's schedule, ``make_train_step`` and
``init_params`` from the configuration's weight seed on the device.  A
pass is one step as ``train`` runs it: the next batch to the device, the
step, and ``float`` of its loss, which waits for the step to finish.

Set-up runs the mix's ``setup_steps`` passes through the same call: the
first takes the bf16 weights of the draw, the rest are float32 as the
window's are.  It keeps what the reference checks them by (``traces``):
their losses, the norm of each leaf's first gradient worked out from the
optimizer's first moments after step 0, and the norm of each leaf's
change over the set-up (the weights drawn again, less the parameters as
the window gets them).  So every kernel and allocation of a float32 step
has run before the window opens, and the window's steps are the ones
that follow, on their own batches.

After the window has closed (and the device's peak has been read),
``traces`` holds one more step through the same call, the held step, and
keeps what the reference follows it by layer by layer: each layer's
input and the last layer's output, the loss's gradient at each (hooks on
the residual stream as ``models.builder._run_layer`` gets and returns it),
every leaf's gradient as AdamW gets it, the loss, and the parameters and
moments before the update and the parameters after it.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Sequence

from uvmbench import lm_flops

#: the architecture's fields the configuration file writes out
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff",
             "vocab", "tie_embeddings", "dtype")

#: what :func:`work` counts
WORK_UNIT = "tokens"


def arch(config: Dict, traffic: Dict):
    """The registry's architecture with the configuration's widths and the
    mix's ``remat`` (equal to the registry's for a full-size cell; the
    tests' small copies change the widths)."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(config["arch"]),
                               **{k: config[k] for k in ARCH_KEYS},
                               remat=bool(traffic["remat"]))


class Program:
    """The system under test, set up for one cell."""

    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: str) -> None:
        import torch
        from repro_torch import kernels
        from repro_torch.data import TokenPipeline
        from repro_torch.launch import train as launch_train
        from repro_torch.models import build_model, init_params
        from repro_torch.optimizer import AdamW, linear_warmup_cosine
        self.torch, self.kernels = torch, kernels
        self.launch_train = launch_train
        self.AdamW, self.TokenPipeline = AdamW, TokenPipeline
        self.device, self.config = device, config
        if traffic["grad_compress"] is not None:
            raise ValueError("the reference has no gradient compression")
        self.setup_s: Dict[str, float] = {}

        t = time.perf_counter()
        self.model = build_model(arch(config, traffic))
        self.batch = int(traffic["batch"])
        self.seq_len = int(traffic["seq_len"])
        self.pipe = TokenPipeline(vocab=int(config["vocab"]),
                                  seq_len=self.seq_len,
                                  batch_size=self.batch, seed=seed % 2 ** 32)
        a = config["adamw"]
        self.b1 = float(a["b1"])
        opt = AdamW(b1=self.b1, b2=a["b2"], eps=a["eps"],
                    weight_decay=a["weight_decay"], clip_norm=a["clip_norm"])
        lr_fn = linear_warmup_cosine(float(traffic["lr"]),
                                     int(traffic["warmup"]),
                                     int(traffic["schedule_steps"]))
        self.step_fn = launch_train.make_train_step(self.model, opt, lr_fn,
                                                    None)
        self.params = init_params(self.model, self._generator())
        self.names = [n for n, _ in self.params.named_parameters()]
        self.opt_state = opt.init(list(self.params.parameters()))
        self.ef_state = None
        self.step = 0
        self.launches: List[int] = []
        self.tf32: List[bool] = []
        self.flops = lm_flops.step_flops(config, self.batch, self.seq_len)
        self._sync()
        self.setup_s["build"] = time.perf_counter() - t

        t = time.perf_counter()
        losses = []
        for i in range(int(traffic["setup_steps"])):
            losses.append(self.run_pass()[0]["loss"])
            if i == 0:
                first = self._norms(self.opt_state.mu, 1.0 / (1.0 - self.b1))
        self.setup_s["steps"] = time.perf_counter() - t

        t = time.perf_counter()
        drawn = init_params(self.model, self._generator())
        change = self._norms(
            p.float() - q.float() for p, q in
            zip(self.params.parameters(), drawn.parameters()))
        del drawn
        self._setup = {"device": device, "setup_losses": losses,
                       "first_grad_norms": first, "change_norms": change}
        # the window's counters start with the window
        self.launches, self.tf32 = [], []
        self.first_window_step = self.step
        self._sync()
        self.setup_s["readings"] = time.perf_counter() - t

    def _generator(self):
        return self.torch.Generator(device=self.device).manual_seed(
            int(self.config["weights_seed"]))

    def _norms(self, tensors, scale: float = 1.0) -> Dict[str, float]:
        torch = self.torch
        with torch.no_grad():
            norms = torch.stack([torch.linalg.vector_norm(t.float())
                                 for t in tensors]) * scale
        return dict(zip(self.names, norms.tolist()))

    def _sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def _kernel_launches(self) -> int:
        return sum(self.kernels.launch_counts().values())

    def run_pass(self) -> List[Dict]:
        """One training step; returns its row."""
        torch = self.torch
        before = self._kernel_launches()
        self.tf32.append(bool(torch.backends.cuda.matmul.allow_tf32))
        batch = {k: torch.from_numpy(v).to(self.device).long()
                 for k, v in self.pipe.next_batch().items()}
        self.params, self.opt_state, self.ef_state, metrics = self.step_fn(
            self.params, self.opt_state, self.ef_state, batch, self.step)
        row = {"step": self.step, "tokens": int(batch["tokens"].numel()),
               "loss": float(metrics["loss"]), "model_flops": self.flops}
        self.step += 1
        self.launches.append(self._kernel_launches() - before)
        return [row]

    def counters(self) -> Dict:
        """Per window pass: K1-K4 launches, and whether TF32 was on."""
        return {"kernel_launches": list(self.launches),
                "tf32": list(self.tf32)}

    def traces(self) -> Dict:
        """What set-up produced that the reference checks, and the held
        step (taken here, once)."""
        if "held" not in self._setup:
            self._setup["held"] = self._hold()
        return self._setup

    def _hold(self) -> Dict:
        """One more step through :meth:`run_pass`, and what the reference
        follows it by."""
        torch = self.torch
        from repro_torch.models import builder
        n_layers = int(self.config["n_layers"])
        named = list(self.params.named_parameters())
        before = {"params": {n: p.detach().clone() for n, p in named},
                  "mu": dict(zip(self.names, (m.clone()
                                              for m in self.opt_state.mu))),
                  "nu": dict(zip(self.names, (v.clone()
                                              for v in self.opt_state.nu))),
                  "opt_step": self.opt_state.step}
        xs: List = []
        gs: Dict[int, object] = {}
        seen: Dict = {}

        def keep_grad(i):
            def hook(g):
                gs[i] = g.detach().clone()
            return hook

        run_layer = builder._run_layer

        def capturing_run_layer(seg, layer_params, h, cfg, **kw):
            # the forward's calls come first; remat's recomputes follow
            capture = len(xs) < n_layers
            out = run_layer(seg, layer_params, h, cfg, **kw)
            if capture:
                h.register_hook(keep_grad(len(xs)))
                xs.append(h.detach())
                if len(xs) == n_layers:
                    out[0].register_hook(keep_grad(n_layers))
                    xs.append(out[0].detach())
            return out

        update = self.AdamW.update

        def capturing_update(opt, grads, params, state, lr):
            seen["grads"] = dict(zip(self.names, (g.detach() for g in grads)))
            return update(opt, grads, params, state, lr)

        builder._run_layer = capturing_run_layer
        self.AdamW.update = capturing_update
        try:
            step = self.step
            row = self.run_pass()[0]
        finally:
            builder._run_layer = run_layer
            self.AdamW.update = update
        self._sync()
        return {"step": step, "xs": xs,
                "gs": [gs.get(i) for i in range(len(xs))],
                "loss": row["loss"], "grads": seen.get("grads", {}),
                "before": before,
                "after": {"params": {n: p.detach() for n, p in
                                     self.params.named_parameters()}}}

    def window_checks(self, passes: Sequence[List[Dict]]) -> Dict[str, int]:
        """Facts of the window that must hold, as counts of breaches: one
        row a pass, the steps consecutive from set-up's last, every step
        the mix's tokens, every loss finite, no K1-K4 launch (training
        attention is ``attend_plain``), TF32 off at every pass."""
        rows = [r for p in passes for r in p]
        want = range(self.first_window_step,
                     self.first_window_step + len(rows))
        return {
            "steps_out_of_order": sum(r["step"] != s
                                      for r, s in zip(rows, want))
            + sum(len(p) != 1 for p in passes),
            "steps_short": sum(r["tokens"] != self.batch * self.seq_len
                               for r in rows),
            "losses_not_finite": sum(not math.isfinite(r["loss"])
                                     for r in rows),
            "kernel_launches": sum(self.launches),
            "tf32_passes": sum(self.tf32),
        }

    def span_targets(self):
        """The program's functions the traced run wraps in spans."""
        torch = self.torch
        return [
            (self.TokenPipeline, "next_batch", "TokenPipeline.next_batch"),
            (self.launch_train, "train_loss", "train.train_loss"),
            (torch.autograd, "grad", "autograd.grad"),
            (self.AdamW, "update", "AdamW.update"),
        ]

    def close(self) -> None:
        """Free the program's state before the reference runs (what the
        held step kept stays with ``traces``)."""
        self.params = self.opt_state = self.step_fn = self.model = None
        gc.collect()
        if self.device == "cuda":
            self.torch.cuda.empty_cache()


def work(rows: Sequence[Dict]) -> int:
    """The tokens of ``rows`` (the window's work)."""
    return sum(int(r["tokens"]) for r in rows)


def end_to_end(rows: Sequence[Dict], window_s: float) -> Dict[str, float]:
    """The window's end-to-end metrics but set-up: every token the window's
    steps trained on over all of its time."""
    return {"train_tokens_per_s": work(rows) / window_s}
