"""Roofline accounting of a dry-run step on NVIDIA H100s.

Counterpart of the reference's ``repro.launch.roofline``.  Three terms per
(arch x shape x mesh), in seconds, each per chip:

    compute    = FLOPs            / PEAK_FLOPS
    memory     = bytes accessed   / HBM_BW
    collective = collective bytes / LINK_BW

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and parses
collective bytes from the compiled HLO.  The port is eager PyTorch: there is
no HLO, so ``launch.dryrun`` counts the step it runs (per partition: the
local shards of every op) and :class:`CollectiveCounter` accounts the
collectives the step issues, from the ``_c10d_functional`` ops that DTensor
dispatches.  The reference's conventions hold: result bytes per partition
(each result's local bytes), an all-reduce counted twice (the
reduce-scatter and all-gather phases of a ring), an asynchronous
collective counted where it starts and not where it is waited on
(``wait_tensor``), counts per kind under ``_counts``.  Broadcasts count as
``collective-permute``; DTensor's ``_dtensor::shard_dim_alltoall`` (a shard
moved from one dim to another) as ``all-to-all``.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit,
from NVIDIA's data sheet: 989 TFLOP/s bf16 dense on the tensor cores,
3.35 TB/s of HBM3.  One collective bandwidth, as in the reference: 50 GB/s
a GPU, one 400 Gb/s NDR InfiniBand link (NVIDIA ConnectX-7, one per GPU in
a DGX H100): a 16-way ``model`` axis leaves the 8-GPU NVLink domain, so a
collective over it runs at the rate of the slowest hop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

PEAK_FLOPS = 989e12        # bf16 dense / GPU
HBM_BW = 3.35e12           # bytes/s / GPU
LINK_BW = 50e9             # bytes/s / GPU (one NDR InfiniBand link)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: ``_c10d_functional`` op name -> the HLO kind it stands for
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_NOT_COUNTED = ("wait_tensor",)


def tensors_of(tree) -> List[torch.Tensor]:
    """Every tensor in ``tree`` (dicts, lists, tuples, named tuples, a
    module's parameters), a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return [tree._local_tensor]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return tensors_of(list(tree.parameters()))
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in tensors_of(item)]
    return []


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_kind(func) -> Optional[str]:
    """The HLO kind a dispatched op stands for, or None if it is no
    collective (or the ``wait_tensor`` that completes one).  DTensor moves
    a shard from one dim to another with its own all-to-all op,
    ``_dtensor::shard_dim_alltoall`` (on the CPU it falls back to an
    all-gather)."""
    name = func.__name__.split(".")[0]
    if func.namespace == "_dtensor":
        return "all-to-all" if name == "shard_dim_alltoall" else None
    if func.namespace not in ("_c10d_functional", "c10d_functional",
                              "_c10d_functional_autograd"):
        return None
    if name in _NOT_COUNTED:
        return None
    if name not in _FUNCTIONAL_KINDS:
        raise ValueError(f"collective accounting: unknown collective {func}")
    return _FUNCTIONAL_KINDS[name]


class CollectiveCounter:
    """Result bytes per partition and counts per collective kind."""

    def __init__(self):
        self.bytes: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.counts: Dict[str, int] = {k: 0 for k in _COLLECTIVES}

    def add(self, func, out) -> bool:
        """Count ``func``'s result ``out`` if it is a collective; whether
        it was one."""
        kind = collective_kind(func)
        if kind is None:
            return False
        factor = 2.0 if kind == "all-reduce" else 1.0
        self.bytes[kind] += factor * sum(nbytes(t) for t in tensors_of(out))
        self.counts[kind] += 1
        return True

    def detail(self) -> Dict:
        """The reference's ``collective_bytes`` dict."""
        out: Dict = dict(self.bytes)
        out["_counts"] = dict(self.counts)
        return out


@dataclasses.dataclass
class Roofline:
    flops: float               # per-partition FLOPs
    hbm_bytes: float           # per-partition bytes accessed
    coll_bytes: float          # per-partition collective bytes
    chips: int
    coll_detail: Optional[Dict] = None

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms (perfect
        overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck, "step_s": self.step_s,
            "coll_detail": {k: v for k, v in (self.coll_detail or {}).items()
                            if k != "_counts"},
            "coll_counts": (self.coll_detail or {}).get("_counts"),
        }


def model_flops(cfg, shape, n_params_active: float) -> float:
    """MODEL_FLOPS = 6*N*D for training (fwd+bwd), 2*N*D for inference, with
    N = active parameter count."""
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape.global_batch
