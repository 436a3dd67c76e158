"""Multi-pod dry-run: prove the distribution config is coherent for every
(architecture x input shape x mesh) cell without the hardware.

Counterpart of the reference's ``repro.launch.dryrun``.  The reference
lowers and compiles the sharded step with XLA against ``ShapeDtypeStruct``s.
The port is eager, so a *lowering* runs the real step once -- the port's
own ``train_loss`` + AdamW update, ``prefill`` or ``decode`` -- with
DTensor parameters, batch and states placed by ``distributed.sharding`` on
a production mesh over a fake process group (``launch.mesh``), under
``FakeTensorMode``: no array is allocated and no collective moves a byte.
:class:`StepCounter` watches every op that reaches the local shards and
records, per partition (so that ``flops x chips`` is the whole program's):

* **FLOPs**: ``torch.utils.flop_counter``'s formula of every product on its
  local shards (``mm``, ``bmm``, ...; K4's registered op counts
  ``kernels.flash_attention.flash_attention_cost``, the work the kernel
  does).  ``FlopCounterMode`` itself is not used: over DTensors it counts
  some ops at their global shapes.
* **Bytes**: the inputs and outputs of every op that is not a view, on its
  local shards.  Eager code fuses nothing, so each op does read its inputs
  from and write its outputs to device memory: the count is the traffic
  of the port's step, not of a fused program.
* **Collectives**: ``launch.roofline.CollectiveCounter`` over the
  ``_c10d_functional`` ops DTensor issues.
* **Peak memory per chip**: live local-shard storage bytes, counting the
  arguments (parameters, optimizer state, batch, decode states), every
  output and every temporary as long as it lives; it stands where the
  reference reads ``memory_analysis``.

The reference's XLA counts a scanned layer's body once and corrects that by
probes of 1 and 2 layers; the port runs its layers in a Python loop, every
layer's ops are counted, so no probe runs and ``roofline_raw`` equals
``roofline``.  Nothing is compiled: ``compile_s`` is 0 and ``lower_s`` is the
fake step's wall time.  A decode cell's step writes position ``seq_len - 1``
of a full cache and attends over all of it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --arch all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --arch llama3-8b --shape train_4k --device cpu
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextvars
import dataclasses
import functools
import json
import multiprocessing
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_arch
from repro_torch.distributed import sharding as S
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.models import build_model, init_params
from repro_torch.models.builder import (DTYPES, decode, init_decode_state,
                                        prefill)
from repro_torch.optimizer import AdamW

MESHES = {"single_pod_16x16": False, "multi_pod_2x16x16": True}
#: archs whose lowering steps through every position or chunk in Python
_LONG_ARCHS = ("recurrentgemma-9b", "mamba2-780m")


def input_specs(cfg, shape, device="cpu") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input, made with ``torch.empty`` (fake
    under ``FakeTensorMode``): tokens int64 as the port's pipeline gives
    them, a VLM's patches, an audio arch's frames."""
    b, s = shape.global_batch, shape.seq_len
    dt = DTYPES[cfg.dtype]
    batch = {"tokens": torch.empty((b, s), dtype=torch.int64, device=device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((b, cfg.frontend_seq, cfg.d_model),
                                       dtype=dt, device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.empty((b, max(s // 8, 8), cfg.d_model),
                                      dtype=dt, device=device)
    return batch


def _reference_leaves(params) -> Dict[Tuple[str, ...], List[torch.Tensor]]:
    """The port's parameters grouped as the reference's leaves: a segment's
    layers stacked under one key."""
    groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] in ("segments", "enc_segments"):
            del parts[2]
        groups.setdefault(tuple(parts), []).append(p)
    return groups


def _active_params(params, cfg) -> Tuple[float, float]:
    """(total_params, active_params): MoE experts count at top_k/E; embeddings
    excluded from active (6*N*D convention).  Over the reference's leaves
    and their stacked shapes, as the reference counts."""
    total = active = 0.0
    frac = (cfg.top_k / cfg.n_experts) if cfg.n_experts else 1.0
    for key, ps in _reference_leaves(params).items():
        shape = tuple(ps[0].shape)
        if key[0] in ("segments", "enc_segments"):
            shape = (len(ps),) + shape
        n = float(sum(p.numel() for p in ps))
        total += n
        name = key[-1]
        if name in ("embed", "head"):
            continue
        is_expert = len(shape) >= 3 and name in ("wg", "wu", "wd") and \
            cfg.n_experts and shape[-3] == cfg.n_experts
        active += n * (frac if is_expert else 1.0)
    return total, active


def decode_state_shardings(model, states, mesh, global_batch):
    """Layouts of the port's decode states, in ``states``' nesting (per
    segment, per layer, block key): batch over (pod, data); a head-major
    (B, Hkv, S, D) cache's heads over model if divisible, else its
    *sequence* dim over model (context parallelism), else replicated; an
    SSD state's (B, H, P, N) heads, an LRU state's (B, D) channels over
    model if divisible.  The reference's layouts of its stacked (L, B, S,
    KV, hd), (L, B, H, P, N) and (L, B, Dr) states, per layer."""
    baxes = S.batch_axes_for(global_batch, mesh) or None
    msize = S.mesh_shape(mesh).get("model", 1)

    def kv_spec(shape):  # (B, Hkv, S, D)
        if shape[1] % msize == 0 and shape[1] >= msize:
            return (baxes, "model", None, None)
        if shape[2] % msize == 0 and shape[2] >= msize:
            return (baxes, None, "model", None)
        return (baxes, None, None, None)

    def one(st):
        if isinstance(st, tuple):
            return tuple(kv_spec(x.shape) for x in st)
        if st.dim() == 4:    # ssd (B, H, P, N)
            return ((baxes, "model", None, None) if st.shape[1] % msize == 0
                    else (baxes, None, None, None))
        return ((baxes, "model") if st.shape[1] % msize == 0    # lru (B, Dr)
                else (baxes, None))

    return [None if seg is None else [
        None if layer is None else {key: one(st) for key, st in layer.items()}
        for layer in seg] for seg in states]


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _is_view(func) -> bool:
    """Whether ``func``'s results alias its inputs without a write (a view,
    or an op that only returns its argument)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


#: ops that move no bytes: allocations, and what completes a collective
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor")

#: set while DTensor derives an op's global output metadata by running it on
#: fake tensors of the global shapes: those calls are no part of the step
_META_PROPAGATION: contextvars.ContextVar = contextvars.ContextVar(
    "dryrun_meta_propagation", default=False)


def _mark_meta_propagation() -> None:
    """Have DTensor's tensor-metadata propagation set
    ``_META_PROPAGATION`` while it runs (installed once)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(orig, "_marks_meta_propagation", False):
        return

    @functools.wraps(orig)
    def wrapped(self, op_schema):
        token = _META_PROPAGATION.set(True)
        try:
            return orig(self, op_schema)
        finally:
            _META_PROPAGATION.reset(token)

    wrapped._marks_meta_propagation = True
    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped


class StepCounter(TorchDispatchMode):
    """FLOPs, bytes, collectives and live memory of the ops dispatched on
    local shards inside it (a DTensor op is let through, ``NotImplemented``,
    so that its local ops and collectives reach this mode).  Enter it above
    ``FakeTensorMode``."""

    def __init__(self):
        super().__init__()
        _mark_meta_propagation()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll = rl.CollectiveCounter()
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        #: op name -> [calls, FLOPs, bytes]
        self.by_op: Dict[str, List[int]] = {}

    def track(self, tensors) -> None:
        """Count the storages of ``tensors`` as live until they are
        freed."""
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def live_bytes(self, tensors) -> int:
        """Bytes of the distinct storages of ``tensors``."""
        seen = {}
        for t in tensors:
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
        return sum(seen.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _META_PROPAGATION.get():
            return out
        self.ops += 1
        outs = rl.tensors_of(out)
        flops = nbytes = 0
        if not self.coll.add(func, out):
            packet = func.overloadpacket
            formula = torch.utils.flop_counter.flop_registry.get(packet)
            if formula is not None:
                flops = formula(*args, **kwargs, out_val=out)
            if not (_is_view(func) or func.namespace == "prim"
                    or func.__name__.split(".")[0] in _NO_TRAFFIC):
                nbytes = sum(rl.nbytes(t) for t in
                             rl.tensors_of(list(args))
                             + rl.tensors_of(list(kwargs.values())) + outs)
        self.flops += flops
        self.bytes += nbytes
        entry = self.by_op.setdefault(str(func.overloadpacket), [0, 0, 0])
        entry[0] += 1
        entry[1] += flops
        entry[2] += nbytes
        self.track(outs)
        return out


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

def distribute_tree(tree, layouts, mesh):
    """``tree`` (nested lists, dicts and tuples of tensors, None kept) with
    each tensor laid out as the layout at the same place in ``layouts``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return S.distribute(tree, layouts, mesh)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, layouts[k], mesh)
                for k, v in tree.items()}
    return type(tree)(distribute_tree(v, lay, mesh)
                      for v, lay in zip(tree, layouts))


def _train_step(model, params, batch, opt_state, opt):
    from repro_torch.launch.train import make_train_step
    step = make_train_step(model, opt, lambda step: 1e-4, None)
    params, opt_state, _, metrics = step(params, opt_state, None, batch, 0)
    return params, opt_state, metrics["loss"]


def _lower_shape(model, cfg, shape, mesh, fsdp: bool, zero1: bool,
                 params, counter: StepCounter) -> Dict[str, Any]:
    """Place ``params`` and the step's inputs, run one shape's step under
    ``counter`` (fake mode and mesh context already entered); returns the
    memory record."""
    device = mesh.device_type
    p_lay = S.param_shardings_stacked(params, mesh, fsdp=fsdp)
    S.distribute_params(params, p_lay, mesh)
    batch = input_specs(cfg, shape, device)
    b_lay = S.batch_shardings(batch, mesh, shape.global_batch)
    batch = {k: S.distribute(v, b_lay[k], mesh) for k, v in batch.items()}

    if shape.kind == "train":
        opt = AdamW(weight_decay=0.1, clip_norm=1.0)
        plist = list(params.parameters())
        opt_state = opt.init(plist)
        o_lay = S.opt_shardings(p_lay, params, mesh, zero1=zero1)
        names = [n for n, _ in params.named_parameters()]
        opt_state = opt_state._replace(**{
            k: S.relayout(getattr(opt_state, k), [o_lay[n] for n in names],
                          mesh) for k in ("mu", "nu")})
        args = [params, opt_state, batch]
        counter.track(rl.tensors_of(args))
        arg_bytes = counter.live
        with counter:
            out = _train_step(model, params, batch, opt_state, opt)
    elif shape.kind == "prefill":
        args = [params, batch]
        counter.track(rl.tensors_of(args))
        arg_bytes = counter.live
        with counter:
            out = prefill(model, params, batch)
    else:  # decode
        cache_len = shape.seq_len
        enc_len = max(shape.seq_len // 8, 8) if cfg.family == "audio" else 0
        states = init_decode_state(model, shape.global_batch, cache_len,
                                   enc_len=enc_len, device=device)
        st_lay = decode_state_shardings(model, states, mesh,
                                        shape.global_batch)
        states = distribute_tree(states, st_lay, mesh)
        tok = S.distribute(
            torch.empty((shape.global_batch, 1), dtype=torch.int64,
                        device=device),
            (S.batch_axes_for(shape.global_batch, mesh) or None, None), mesh)
        args = [params, states, tok]
        counter.track(rl.tensors_of(args))
        arg_bytes = counter.live
        with counter:
            out = decode(model, params, states, tok, cache_len - 1)
    peak = counter.peak
    return {"argument_bytes": arg_bytes,
            "output_bytes": counter.live_bytes(rl.tensors_of(out)),
            "temp_bytes": peak - arg_bytes, "peak_bytes": peak}


def lower_cell(arch: str, shape_name, mesh, *, fsdp: bool = True,
               zero1: bool = True,
               cfg_override: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Lower one (arch, shape, mesh) cell: run its step on fake DTensors
    and return the record.  ``shape_name`` names an entry of ``SHAPES`` or
    is a ``ShapeSpec``.  (The reference's ``probes`` has no counterpart:
    see the module docstring.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_arch(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    model = build_model(cfg)
    chips = mesh.size()
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "chips": chips,
        "mesh": S.mesh_shape(mesh), "status": "ok", "fsdp": fsdp,
        "zero1": zero1, "cfg_override": cfg_override or {},
    }

    if shape.kind == "decode" and shape.name == "long_500k" \
            and not cfg.subquadratic:
        rec["status"] = "skipped"
        rec["reason"] = ("full quadratic-attention family: 512k-token KV "
                         "decode excluded per assignment (sub-quadratic "
                         "archs only)")
        return rec

    counter = StepCounter()
    with FakeTensorMode(), S.mesh_context(mesh):
        params = init_params(model, torch.Generator(
            device=mesh.device_type).manual_seed(0), device=mesh.device_type)
        total, active = _active_params(params, cfg)
        rec["params_total"] = total
        rec["params_active"] = active
        t0 = time.time()
        rec["memory"] = _lower_shape(model, cfg, shape, mesh, fsdp, zero1,
                                     params, counter)
        rec["lower_s"] = time.time() - t0
    rec["compile_s"] = 0.0
    rec["ops"] = counter.ops
    rec["k4_calls"] = counter.by_op.get("repro_torch.flash_attention",
                                        [0])[0]
    rec["top_ops"] = {
        key: [[name, *v] for name, v in sorted(
            counter.by_op.items(), key=lambda kv: -kv[1][i])[:8]]
        for key, i in (("by_flops", 1), ("by_bytes", 2))}
    roof = rl.Roofline(flops=float(counter.flops),
                       hbm_bytes=float(counter.bytes),
                       coll_bytes=float(sum(counter.coll.bytes.values())),
                       chips=chips, coll_detail=counter.coll.detail())
    rec["roofline_raw"] = roof.as_dict()
    rec["roofline"] = roof.as_dict()
    mf = rl.model_flops(cfg, shape, active)
    rec["model_flops"] = mf
    # per-partition flops x chips = whole-program flops
    total_flops = roof.flops * chips
    rec["useful_flops_ratio"] = (mf / total_flops) if total_flops else None
    return rec


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cell_record(mesh_name: str, arch: str, shape_name: str,
                 device_type: str) -> Dict[str, Any]:
    """One cell on its production mesh (over a fake world of 512 ranks,
    made here if this process has none); a cell that raises is recorded
    ``failed`` with its error."""
    init_fake_world(512)
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name],
                                device_type=device_type)
    t0 = time.time()
    try:
        rec = lower_cell(arch, shape_name, mesh)
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name,
               "mesh": S.mesh_shape(mesh), "status": "failed",
               "error": str(e),
               "traceback": traceback.format_exc()[-2000:]}
    rec["wall_s"] = time.time() - t0
    return rec


def _print_status(rec: Dict[str, Any]) -> None:
    status = rec["status"]
    if status == "ok":
        r = rec["roofline"]
        extra = (f"bottleneck={r['bottleneck']} "
                 f"step={r['step_s']*1e3:.2f}ms "
                 f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB "
                 f"wall={rec['wall_s']:.1f}s")
    elif status == "skipped":
        extra = rec["reason"][:60]
    else:
        extra = rec["error"][:120]
    print(f"  -> {rec['arch']} {rec['shape']} {status} {extra}", flush=True)


def run(args) -> int:
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append("single_pod_16x16")
    if args.mesh in ("multi", "both"):
        meshes.append("multi_pod_2x16x16")
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    os.makedirs(args.out, exist_ok=True)
    todo = []
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                out_dir = os.path.join(args.out, mesh_name,
                                       arch.replace("/", "_"))
                os.makedirs(out_dir, exist_ok=True)
                out_path = os.path.join(out_dir, f"{shape_name}.json")
                if os.path.exists(out_path) and not args.force:
                    print(f"[cached] {mesh_name} {arch} {shape_name}")
                    continue
                todo.append((mesh_name, arch, shape_name, out_path))
    # longest first: the recurrent archs' scans step through every
    # position, then the training steps
    todo.sort(key=lambda job: (job[1] not in _LONG_ARCHS,
                               SHAPES[job[2]].kind != "train"))
    failures = 0

    def done(job, rec):
        nonlocal failures
        with open(job[3], "w") as f:
            json.dump(rec, f, indent=2, default=str)
        failures += rec["status"] == "failed"
        _print_status(rec)

    if args.workers <= 1:
        for job in todo:
            print(f"[dryrun] {job[0]} {job[1]} {job[2]} ...", flush=True)
            done(job, _cell_record(*job[:3], args.device))
        return failures
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.workers,
                                                mp_context=ctx) as pool:
        futures = {pool.submit(_cell_record, *job[:3], args.device): job
                   for job in todo}
        for fut in concurrent.futures.as_completed(futures):
            job = futures[fut]
            print(f"[dryrun] {job[0]} {job[1]} {job[2]}", flush=True)
            done(job, fut.result())
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and the mesh "
                         "(cuda by default; cpu on a host without a card)")
    ap.add_argument("--workers", type=int, default=1,
                    help="lower cells in this many spawned processes")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to lower with CPU fakes")
    failures = run(args)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")
    print("dry-run complete: all cells ok")


if __name__ == "__main__":
    main()
