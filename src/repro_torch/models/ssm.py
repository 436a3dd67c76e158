"""Mamba-2 SSD (state-space duality) block.

Counterpart of the reference's ``repro.models.ssm``.  Chunked linear
recurrence (Dao & Gu, 2024): within a chunk the quadratic
"attention-like" form; across chunks a scalar-decay recurrence carries the
(B, H, P, N) state, here a Python loop over the chunks (the reference's
``lax.scan``).  Decode is O(1): one state update per token.  On DTensors
(under a mesh) the mixer runs shard by shard (:func:`_per_shard`).

Shapes: d_inner = 2 * d_model, P = head_dim, H = d_inner / P,
N = ssm_state, one B/C group.  Where the reference mixes float32 (the
decay) with the model's type, JAX promotes to float32; the port casts to
float32 at the same places.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import local_shard
from repro_torch.models.layers import rmsnorm


def _ssd_chunked(x, dt, a_log, b, c, chunk: int):
    """x: (B,S,H,P); dt: (B,S,H); b,c: (B,S,N).  Returns (y (B,S,H,P),
    final state (B,H,P,N)), both in x's type."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd: {s} positions are not whole chunks of {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xa = (x * dt[..., None]).reshape(bsz, nc, chunk, h, p).to(f32)
    la = (-torch.exp(a_log)[None, None, :] * dt).reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    ys = []
    for ci in range(nc):
        xa_c, la_c, b_c, c_c = xa[:, ci], la[:, ci], bc[:, ci], cc[:, ci]
        cum = torch.cumsum(la_c, dim=1)                      # (B,L,H)
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        decay = torch.where(causal[None, :, :, None], decay,
                            decay.new_zeros(()))
        scores = torch.einsum("bln,bsn->bls", c_c, b_c).to(f32)  # (B,L,L)
        y = torch.einsum("bls,blsh,bshp->blhp", scores, decay, xa_c)
        # contribution of the carried state
        y = y + torch.einsum("bln,blh,bhpn->blhp", c_c.to(f32),
                             torch.exp(cum), state)
        total = cum[:, -1]                                   # (B,H)
        sdecay = torch.exp(total[:, None, :] - cum)          # (B,L,H)
        state = (state * torch.exp(total)[..., None, None]
                 + torch.einsum("bsh,bsn,bshp->bhpn", sdecay, b_c.to(f32),
                                xa_c))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    return y.to(x.dtype), state.to(x.dtype)


def _ssd_core(xh, dt, a_log, b_in, c_in, state, *, chunk: int, dtype):
    """The SSD mixer: xh (B,S,H,P), dt (B,S,H), a_log (H,), b_in/c_in
    (B,S,N), state (B,H,P,N) or None -> (y (B,S,H,P), new state).  A
    decode step (S == 1 with a state) is one state update."""
    if xh.shape[1] == 1 and state is not None:
        # decode: h' = exp(-exp(A) dt) h + dt * B x ; y = C h'
        la = -torch.exp(a_log)[None, None, :] * dt             # (B,1,H)
        dec = torch.exp(la).to(dtype)                          # (B,1,H)
        xb = torch.einsum("bshp,bsn->bhpn",
                          xh * dt[..., None].to(dtype), b_in)
        new_state = (state * dec[:, 0, :, None, None] + xb).to(dtype)
        y = torch.einsum("bhpn,bsn->bshp", new_state, c_in)
        return y, new_state
    return _ssd_chunked(xh, dt, a_log, b_in, c_in, chunk)


def _per_shard(core, xh, dt, a_log, b_in, c_in, state):
    """``core`` on each rank's shards: the mixer is independent per batch
    row and head, so xh's batch and head shards fix every input's (dt's
    and the state's alike, a_log's heads, b_in's and c_in's batch), and
    whatever else is whole.  DTensor cannot run the mixer's einsums
    itself: they flatten the batch and head dims into one, sharded over
    two axes, which ``aten.bmm`` has no strategy for."""
    mesh = xh.device_mesh

    def lay(batch_dim, head_dim):
        return [Shard(batch_dim) if p == Shard(0) and batch_dim is not None
                else
                Shard(head_dim) if p == Shard(2) and head_dim is not None
                else Replicate() for p in xh.placements]

    want = {"x": lay(0, 2), "dt": lay(0, 2), "a": lay(None, 0),
            "bc": lay(0, None), "state": lay(0, 1)}
    args = [local_shard(xh.redistribute(mesh, want["x"])),
            local_shard(dt.redistribute(mesh, want["dt"])),
            local_shard(a_log.redistribute(mesh, want["a"])),
            local_shard(b_in.redistribute(mesh, want["bc"])),
            local_shard(c_in.redistribute(mesh, want["bc"])),
            None if state is None else
            local_shard(state.redistribute(mesh, want["state"]))]
    y, new_state = (t.contiguous() for t in core(*args))
    b, s, h, p = xh.shape
    n = b_in.shape[-1]
    return (DTensor.from_local(y, mesh, want["x"], run_check=False,
                               shape=xh.shape, stride=(s * h * p, h * p, p,
                                                       1)),
            DTensor.from_local(new_state, mesh, want["state"],
                               run_check=False, shape=(b, h, p, n),
                               stride=(h * p * n, p * n, n, 1)))


def ssd_block(x: torch.Tensor, p: Dict, *, head_dim: int, ssm_state: int,
              chunk: int = 256,
              state: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, final_state).  state (B, H, P, N) enables O(1) decode
    when x has S == 1."""
    bsz, s, d = x.shape
    h = rmsnorm(x, p["ln"])
    d_inner = p["wx"].shape[1] // 2
    nheads = d_inner // head_dim
    xz = h @ p["wx"]                                           # (B,S,2*din)
    xi, z = torch.split(xz, d_inner, dim=-1)
    bc = h @ p["wbc"]                                          # (B,S,2N)
    b_in, c_in = torch.split(bc, bc.shape[-1] // 2, dim=-1)
    dt = F.softplus(h @ p["wdt"] + p["dt_bias"])               # (B,S,H)
    xh = xi.reshape(bsz, s, nheads, head_dim)

    core = functools.partial(_ssd_core, chunk=min(chunk, s), dtype=x.dtype)
    if isinstance(xh, DTensor):
        y, new_state = _per_shard(core, xh, dt, p["a_log"], b_in, c_in, state)
    else:
        y, new_state = core(xh, dt, p["a_log"], b_in, c_in, state)
    y = y.reshape(bsz, s, d_inner).to(x.dtype) * F.silu(z)
    out = y @ p["wo"]
    return (x + out).to(x.dtype), new_state
