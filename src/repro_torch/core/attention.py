"""Attention for the predictor: full softmax attention and the paper's HLSH
(Hamming-based LSH) attention (Algorithm 1) in its mask formulation.

HLSH erases rows whose Hamming score is >= HTOP (near-orthogonal to
everything: negligible dot products) and lets near-duplicate rows (score
<= HBOT) share one representative's output.  As in the reference
``repro.core.attention``, erase is a multiplicative keep mask on Q and K and
share is a gather on the output rows.

The reference draws the hash projection and the half-sample from
``jax.random`` inside :func:`hlsh_plan`.  Here both are explicit inputs; see
:func:`lsh_draws` for where they come from.
"""
from __future__ import annotations

import json
import math
import os
from typing import NamedTuple, Tuple

import torch

#: JAX's draws for the simplified predictor's HLSH layer, under
#: ``jax.random.PRNGKey(7)``: the projection ``r`` and the half-sample ``sel``
DRAWS_FILE = os.path.join(os.path.dirname(__file__), "hlsh_draws.json")


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """(B, N, D) softmax(QK^T/sqrt(D))V."""
    d = q.shape[-1]
    logits = torch.einsum("bnd,bmd->bnm", q, k) / math.sqrt(d)
    return torch.einsum("bnm,bmd->bnd", torch.softmax(logits, dim=-1), v)


def lsh_draws(d: int, n_hashes: int, n_buckets: int, n: int, lsh_seed: int,
              device: torch.device | str = "cpu"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash projection ``r`` (d, n_hashes, n_buckets // 2) float32 and
    the half-sample ``sel`` (max(n // 2, 1),) int64 of :func:`hlsh_plan`.

    For the simplified predictor's configuration (the shape and seed stored
    in :data:`DRAWS_FILE`) these are JAX's own draws, so the port computes
    the reference's function.  Any other configuration draws them from a
    ``torch.Generator`` seeded with ``lsh_seed``: the same distributions as
    the reference (a standard normal projection, a sample without
    replacement), but not its numbers."""
    m = max(n // 2, 1)
    with open(DRAWS_FILE) as f:
        doc = json.load(f)
    if ((doc["d"], doc["n_hashes"], doc["n_buckets"], doc["n"],
         doc["lsh_seed"]) == (d, n_hashes, n_buckets, n, lsh_seed)):
        r = torch.tensor(doc["r"], dtype=torch.float32)
        sel = torch.tensor(doc["sel"], dtype=torch.int64)
    else:
        g = torch.Generator().manual_seed(lsh_seed)
        r = torch.randn((d, n_hashes, n_buckets // 2), generator=g,
                        dtype=torch.float32)
        sel = torch.randperm(n, generator=g)[:m]
    return r.to(device), sel.to(device)


def lsh_hash(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Angular LSH (Reformer): projections + argmax over [xR; -xR].
    Returns (B, N, n_hashes) int64 bucket ids."""
    proj = torch.einsum("bnd,dhr->bnhr", x, r)
    proj = torch.cat([proj, -proj], dim=-1)
    return torch.argmax(proj, dim=-1)


class HLSHPlan(NamedTuple):
    """The data-dependent part of HLSH, computed once per sequence:
    keep mask (B, N) and output share map (B, N) of source indices."""
    keep: torch.Tensor
    share_src: torch.Tensor
    hscore: torch.Tensor


def hlsh_plan(qk: torch.Tensor, r: torch.Tensor, sel: torch.Tensor,
              n_hashes: int = 8, htop: float = 0.9, hbot: float = 0.1,
              ) -> HLSHPlan:
    """Algorithm 1, lines 1-3: LSH bucketing, Hamming scoring against a
    random half of the entries (``sel``), geometric-mean reduction, and the
    erase/share decisions.  ``r`` and ``sel`` come from :func:`lsh_draws`."""
    b, n, _ = qk.shape
    qn = qk / (torch.linalg.vector_norm(qk, dim=-1, keepdim=True) + 1e-6)
    h = lsh_hash(qn, r)                                     # (B,N,H)
    h_sel = h[:, sel]                                       # (B,M,H)
    ham = (h[:, :, None, :] != h_sel[:, None, :, :]).sum(-1)  # (B,N,M)
    # geometric mean over the sampled entries (line 3)
    hscore = torch.exp(torch.mean(torch.log(ham.to(torch.float32) + 1.0),
                                  dim=2)) - 1.0             # (B,N)
    erase = hscore >= htop * n_hashes
    low = hscore <= hbot * n_hashes
    # first low entry is the representative (lines 9-16)
    any_low = low.any(dim=1, keepdim=True)
    base = torch.argmax(low.to(torch.uint8), dim=1)         # (B,)
    idx = torch.arange(n, device=qk.device)[None, :]
    is_base = idx == base[:, None]
    keep = (~erase) & (~low | is_base)
    share_src = torch.where(low & any_low, base[:, None], idx.expand(b, n))
    return HLSHPlan(keep=keep, share_src=share_src, hscore=hscore)


def hlsh_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               plan: HLSHPlan) -> torch.Tensor:
    """Masked attention plus the share map, differentiable (the training
    path; inference on the card goes through the K2 kernel,
    ``repro_torch.kernels.ops.hlsh_attention``)."""
    d = q.shape[-1]
    keep = plan.keep[..., None].to(q.dtype)
    qm = q * keep
    km = k * keep
    logits = torch.einsum("bnd,bmd->bnm", qm, km) / math.sqrt(d)
    out = torch.einsum("bnm,bmd->bnd", torch.softmax(logits, dim=-1), v)
    # copy the representative's output into the erased near-duplicates
    return torch.gather(out, 1, plan.share_src[..., None].expand_as(out))
