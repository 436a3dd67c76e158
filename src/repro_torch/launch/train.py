"""Training launcher: the LM zoo trained on the synthetic token pipeline with
the in-repo AdamW, optional gradient compression with error feedback,
asynchronous atomic checkpoints and heartbeat beats.  Counterpart of the
reference's ``repro.launch.train``.

The step runs eagerly on ``--device`` (``cuda`` by default; with no card it
exits with an error unless ``--device cpu`` is given).  :func:`main` runs it
on a (1, n) ``("data", "model")`` mesh over the ranks that exist
(``launch.mesh.make_host_mesh``: NCCL on the card, gloo on the CPU), as the
reference's does: :func:`build_sharded_train` places the parameters, the
AdamW moments, the error feedback and the batch by
``distributed.sharding``'s rules as DTensors, so ``TrainConfig.fsdp`` shards
large weights over ``data`` and ``--zero1`` the moments (on a mesh of one
rank each shard is the whole tensor, and the step computes the unmeshed
step's values bit for bit).  Training attention takes the differentiable path
(``models.layers.attend_plain``), never K4, and the full-size configs set
``remat``, so each layer's activations are recomputed in the backward pass.
A step's wall time is taken after ``torch.cuda.synchronize()``.

As in the reference, a bf16 model's parameters come out of the first step
float32 (``repro_torch.optimizer.adam``), and a resumed run restores the
parameters and the pipeline only: the optimizer and error-feedback state
start fresh.  Only text archs train: a VLM's or an audio arch's batch lacks
its ``patches`` or ``frames`` and ``train_loss`` raises ``KeyError``, as the
reference's does.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 50 --batch 8 --seq 256 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --batch 8 --seq 2048                  # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.distributed import sharding as S
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, init_params, train_loss
from repro_torch.models.builder import LMParams
from repro_torch.optimizer import (AdamW, AdamWState, ErrorFeedbackState,
                                   compress_with_error_feedback,
                                   init_error_feedback, linear_warmup_cosine)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    grad_compress: Optional[str] = None    # None | "int8" | "topk"
    zero1: bool = False
    fsdp: bool = False
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None


def make_train_step(model, opt: AdamW, lr_fn, grad_compress: Optional[str]):
    """Returns step(params, opt_state, ef_state, batch, step) ->
    (params, opt_state, ef_state, metrics): the loss and its gradient, then
    the optional compression with error feedback (over the reference's
    leaves: a segment's layers compressed as one tensor), then
    ``opt.update``.
    ``params`` (``LMParams``) is updated in place and returned."""

    def step_fn(params: LMParams, opt_state: AdamWState,
                ef_state: Optional[ErrorFeedbackState],
                batch: Dict[str, torch.Tensor], step: int):
        plist = list(params.parameters())
        loss, aux = train_loss(model, params, batch)
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(plist, grads)]
        if grad_compress is not None:
            # compress the gradient that would cross the slow data-parallel
            # link; error feedback keeps the scheme unbiased over time
            grads, ef_state = compress_with_error_feedback(
                grads, ef_state, mode=grad_compress,
                groups=params.leaf_groups())
        opt_state = opt.update(grads, plist, opt_state, lr_fn(step))
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}}
        return params, opt_state, ef_state, metrics

    return step_fn


def build_sharded_train(model, mesh, tc: TrainConfig, shape_batch):
    """Counterpart of the reference's ``build_sharded_train``: returns
    (step_fn, shardings).  ``step_fn`` is :func:`make_train_step`'s step run
    inside ``mesh``'s context on DTensor state, the batch distributed by
    ``shardings["batch"]``, and the parameters, moments and residuals laid
    out again by their rules after the update (AdamW replaces a tensor whose
    type changes).  ``shardings`` holds the layouts by parameter name
    (``params``, ``opt``, ``ef`` or None; ``batch`` by input name), the
    ``AdamW`` (``optd``) and ``place(params, opt_state, ef_state)``, which
    distributes fresh state by them (parameters in place)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    opt = AdamW(weight_decay=0.1, clip_norm=1.0)
    lr_fn = linear_warmup_cosine(tc.lr, tc.warmup, tc.steps)
    inner = make_train_step(model, opt, lr_fn, tc.grad_compress)
    with FakeTensorMode():
        params_shape = init_params(model, torch.Generator().manual_seed(0))
    p_sh = S.param_shardings_stacked(params_shape, mesh, fsdp=tc.fsdp)
    o_sh = S.opt_shardings(p_sh, params_shape, mesh, zero1=tc.zero1)
    ef_sh = o_sh if tc.grad_compress else None
    b_sh = S.batch_shardings(shape_batch, mesh,
                             next(iter(shape_batch.values())).shape[0])
    names = [n for n, _ in params_shape.named_parameters()]
    p_lays = [p_sh[n] for n in names]
    o_lays = [o_sh[n] for n in names]

    def place(params, opt_state, ef_state):
        S.distribute_params(params, p_sh, mesh)
        opt_state = opt_state._replace(**{
            k: S.relayout([S.distribute(t, p_sh[n], mesh) for n, t in
                           zip(names, getattr(opt_state, k))], o_lays, mesh)
            for k in ("mu", "nu")})
        if ef_state is not None:
            ef_state = ef_state._replace(residual=S.relayout(
                [S.distribute(t, p_sh[n], mesh) for n, t in
                 zip(names, ef_state.residual)], o_lays, mesh))
        return params, opt_state, ef_state

    def step_fn(params, opt_state, ef_state, batch, step):
        with S.mesh_context(mesh):
            batch = {k: S.distribute(v, b_sh[k], mesh)
                     for k, v in batch.items()}
            params, opt_state, ef_state, metrics = inner(
                params, opt_state, ef_state, batch, step)
            plist = list(params.parameters())
            for p, t in zip(plist, S.relayout(plist, p_lays, mesh)):
                if t is not p:
                    S.set_data(p, t.detach())
            opt_state = opt_state._replace(
                mu=S.relayout(opt_state.mu, o_lays, mesh),
                nu=S.relayout(opt_state.nu, o_lays, mesh))
            if ef_state is not None:
                ef_state = ef_state._replace(residual=S.relayout(
                    ef_state.residual, o_lays, mesh))
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return params, opt_state, ef_state, metrics

    return step_fn, dict(params=p_sh, opt=o_sh, ef=ef_sh, batch=b_sh,
                         optd=opt, place=place)


@dataclasses.dataclass
class TrainResult:
    """What one :func:`train` run produced."""
    arch: str
    start: int                        # first step run (after a resume)
    losses: List[float]               # one per step run
    step_s: List[float]               # wall seconds per step, synchronized
    params: LMParams
    opt_state: AdamWState
    ef_state: Optional[ErrorFeedbackState]
    pipeline_state: Dict[str, int]
    save_block_s: List[float]         # how long each save_async held the loop
    write_s: List[float]              # each checkpoint's write, in the writer
    wait_s: float                     # the final wait for the writer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(arch: str, tc: TrainConfig = TrainConfig(), *, batch: int = 8,
          seq: int = 256, reduced: bool = False, resume: bool = False,
          device: str = "cuda", mesh=None,
          callback: Optional[Callable[..., Any]] = None) -> TrainResult:
    """Train ``arch`` from random weights drawn on ``device`` from seed 0
    for ``tc.steps`` steps of ``batch`` x ``seq`` tokens, printing the
    reference's lines; ``callback(step, params, opt_state, ef_state,
    metrics)`` runs after each step.  With a ``mesh`` (on ``device``'s
    type) the step is :func:`build_sharded_train`'s and the state
    DTensors."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, batch_size=batch)
    if mesh is None:
        opt = AdamW(weight_decay=0.1, clip_norm=1.0)
        lr_fn = linear_warmup_cosine(tc.lr, tc.warmup, tc.steps)
        step_fn = make_train_step(model, opt, lr_fn, tc.grad_compress)
    else:
        step_fn, sh = build_sharded_train(model, mesh, tc, {
            "tokens": torch.empty((batch, seq), dtype=torch.int64,
                                  device="meta")})
        opt = sh["optd"]
    params = init_params(model, torch.Generator(device=device).manual_seed(0))
    plist = list(params.parameters())
    opt_state = opt.init(plist)
    ef_state = init_error_feedback(plist) if tc.grad_compress else None
    if mesh is not None:
        params, opt_state, ef_state = sh["place"](params, opt_state,
                                                  ef_state)

    ckpt = (CheckpointManager(tc.checkpoint_dir)
            if tc.checkpoint_dir else None)
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        params, extra = ckpt.restore(params)
        pipe.restore(extra["pipeline"])
        start = extra["step"]
        print(f"resumed from step {start}")

    hb = HeartbeatMonitor()
    losses, step_s, save_block_s = [], [], []
    for step in range(start, tc.steps):
        _sync(device)
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(device).long()
             for k, v in pipe.next_batch().items()}
        params, opt_state, ef_state, metrics = step_fn(
            params, opt_state, ef_state, b, step)
        _sync(device)
        dt = time.perf_counter() - t0
        hb.beat(host=0, step_time_s=dt)
        losses.append(float(metrics["loss"]))
        step_s.append(dt)
        if callback is not None:
            callback(step, params, opt_state, ef_state, metrics)
        if step % 10 == 0 or step == tc.steps - 1:
            print(f"step {step:5d} loss={losses[-1]:.4f} "
                  f"({dt*1000:.0f} ms)")
        if ckpt and (step + 1) % tc.checkpoint_every == 0:
            t0 = time.perf_counter()
            ckpt.save_async(step + 1, params,
                            {"step": step + 1, "pipeline": pipe.state()})
            save_block_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    if ckpt:
        ckpt.wait()
    return TrainResult(
        arch=arch, start=start, losses=losses, step_s=step_s, params=params,
        opt_state=opt_state, ef_state=ef_state, pipeline_state=pipe.state(),
        save_block_s=save_block_s, write_s=ckpt.write_s if ckpt else [],
        wait_s=time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) config of the arch")
    ap.add_argument("--grad-compress", choices=["int8", "topk"], default=None)
    ap.add_argument("--zero1", action="store_true",
                    help="shard the optimizer state over data-parallel "
                         "ranks")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda by default)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        ap.error("no CUDA device; pass --device cpu to train on the CPU")

    tc = TrainConfig(steps=args.steps, lr=args.lr,
                     grad_compress=args.grad_compress, zero1=args.zero1,
                     checkpoint_dir=args.checkpoint_dir)
    started = not torch.distributed.is_initialized()
    mesh = make_host_mesh(torch.device(args.device).type)
    try:
        train(args.arch, tc, batch=args.batch, seq=args.seq,
              reduced=args.reduced, resume=args.resume, device=args.device,
              mesh=mesh)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
