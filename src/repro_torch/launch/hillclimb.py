"""Performance hillclimbing over the three selected dry-run cells.

Counterpart of the reference's ``repro.launch.hillclimb``: the same cells
and variants (``CELLS``).  Each variant re-lowers the cell
(``launch.dryrun.lower_cell``: the port's step on fake DTensors on the
single-pod mesh) and records its roofline terms under the H100 constants;
the log captures hypothesis -> change -> before -> after.  In
``llama3_decode``'s ``tp_bf16_logits`` the attention blocks run K4, which
takes its logits and softmax in float32 whatever ``attn_f32_logits`` says:
the knob reaches only the training path's ``attend_plain``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen3_train
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell all \
        --device cpu
"""
import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import init_fake_world, make_production_mesh

# Each variant: (name, hypothesis, kwargs for lower_cell)
CELLS = {
    # Worst useful-flops ratio + compute-bound: the 235B MoE train step.
    "qwen3_train": {
        "arch": "qwen3-moe-235b-a22b", "shape": "train_4k",
        "why": ("worst roofline fraction of the 40-cell baseline "
                "(useful-flops ratio ~0.2, compute-bound)"),
        "variants": [
            ("einsum_dispatch", "iteration 0a: global one-hot einsum MoE "
             "dispatch costs O(T^2 K D) MXU flops — expected to be "
             "compute-catastrophic at 65k tokens/shard",
             {"cfg_override": {"moe_dispatch": "einsum"}}),
            ("scatter_dispatch", "iteration 0b: scatter-add dispatch has "
             "minimal flops but GSPMD lowers sharded scatter to replicated "
             "data movement — expected collective-catastrophic",
             {"cfg_override": {"moe_dispatch": "scatter"}}),
            ("baseline", "grouped (GShard-style) dispatch: token groups "
             "bound the quadratic dispatch term, einsum form keeps the "
             "all-to-all lowering; remat on, capacity 1.25, FSDP+ZeRO1",
             {}),
            ("no_remat", "remat recomputes every block in backward: "
             "dropping it should cut HLO flops ~25-30% at higher live "
             "memory", {"cfg_override": {"remat": False}}),
            ("cap_1.0", "MoE dispatch capacity 1.25->1.0 removes 20% of "
             "expert FLOPs (dropped tokens) and shrinks all-to-all "
             "payloads by the same factor",
             {"cfg_override": {"capacity_factor": 1.0}}),
            ("group_128", "the dispatch one-hot tensor is T*K*1.25*Tg*K "
             "elements — linear in group size; 512->128 should cut the "
             "dominant memory term ~4x at higher drop variance",
             {"cfg_override": {"moe_group_tokens": 128}}),
            ("group_64", "further halve the dispatch tensor (drop variance "
             "grows: 5 slots/expert/group)",
             {"cfg_override": {"moe_group_tokens": 64}}),
            ("combo", "no_remat + cap_1.0 + group_128",
             {"cfg_override": {"remat": False, "capacity_factor": 1.0,
                               "moe_group_tokens": 128}}),
        ],
    },
    # Most collective-bound cell of the baseline table.
    "mamba2_train": {
        "arch": "mamba2-780m", "shape": "train_4k",
        "why": "most collective-bound baseline cell",
        "variants": [
            ("baseline", "FSDP+ZeRO1 on a 780M model", {}),
            ("no_fsdp", "780M params fit per-chip even unsharded on data; "
             "FSDP's per-layer all-gathers are pure overhead at this scale "
             "-> collective term should collapse", {"fsdp": False}),
            ("no_fsdp_chunk256", "bigger SSD chunks halve the number of "
             "inter-chunk state exchanges and scan steps",
             {"fsdp": False, "cfg_override": {"ssd_chunk": 256}}),
            ("no_fsdp_no_remat", "also drop remat: fewer recomputed "
             "collectives in backward",
             {"fsdp": False, "cfg_override": {"remat": False}}),
        ],
    },
    # Most representative of the paper's technique: latency-bound decode
    # with a 32k KV cache (the page-paging serving regime).
    "llama3_decode": {
        "arch": "llama3-8b", "shape": "decode_32k",
        "why": ("serving/KV-cache regime the paper's prefetcher targets; "
                "decode latency is what page-miss stalls would add to"),
        "variants": [
            ("baseline", "training-style sharding reused for serving "
             "(FSDP weights)", {}),
            ("tp_resident", "FSDP weights must be all-gathered EVERY decode "
             "step; serving wants TP-resident weights -> collective term "
             "should drop by ~2x params/chips bytes", {"fsdp": False}),
            ("tp_bf16_logits", "TP-resident + bf16 attention logits over "
             "the 32k cache (halves decode attention bytes)",
             {"fsdp": False,
              "cfg_override": {"attn_f32_logits": False}}),
        ],
    },
}


def run_cell(name: str, out_dir: str, device_type: str = "cuda") -> None:
    spec = CELLS[name]
    init_fake_world(512)
    mesh = make_production_mesh(device_type=device_type)
    os.makedirs(out_dir, exist_ok=True)
    print(f"== hillclimb {name}: {spec['arch']} x {spec['shape']} ==")
    print(f"   rationale: {spec['why']}")
    for vname, hypothesis, kw in spec["variants"]:
        path = os.path.join(out_dir, f"{name}.{vname}.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            print(f"  [cached] {vname}")
        else:
            print(f"  [lower] {vname}: {hypothesis[:70]}...", flush=True)
            t0 = time.time()
            try:
                rec = lower_cell(spec["arch"], spec["shape"], mesh, **kw)
                rec["variant"] = vname
                rec["hypothesis"] = hypothesis
            except Exception as e:
                rec = {"variant": vname, "status": "failed",
                       "error": str(e),
                       "traceback": traceback.format_exc()[-1500:]}
            rec["wall_s"] = time.time() - t0
            with open(path, "w") as f:
                json.dump(rec, f, indent=2, default=str)
        if rec.get("status") == "ok":
            r = rec["roofline"]
            print(f"    -> compute={r['compute_s']*1e3:9.2f}ms "
                  f"memory={r['memory_s']*1e3:9.2f}ms "
                  f"collective={r['collective_s']*1e3:9.2f}ms "
                  f"bottleneck={r['bottleneck']} "
                  f"wall={rec.get('wall_s', 0):.1f}s", flush=True)
        else:
            print(f"    -> FAILED {rec.get('error', '')[:100]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all",
                    choices=list(CELLS) + ["all"])
    ap.add_argument("--out", default="experiments/perf")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and the mesh "
                         "(cuda by default; cpu on a host without a card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to lower with CPU fakes")
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    for c in cells:
        run_cell(c, args.out, args.device)


if __name__ == "__main__":
    main()
