"""Sharding rules: logical parameter/activation layouts -> DTensor placements.

Counterpart of the reference's ``repro.distributed.sharding``, on
``torch.distributed.device_mesh.DeviceMesh`` and ``torch.distributed.
tensor``.  Mesh axes:

* ``pod``   -- pure data parallelism across pods.
* ``data``  -- intra-pod data parallelism (FSDP and ZeRO-1 sharding).
* ``model`` -- tensor parallelism: attention heads, FFN hidden, MoE experts,
               vocab, SSM inner channels.

A *layout* is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, each an axis name, a tuple of axis names or None.  Every rule is
divisibility-checked against the mesh: a dimension that does not divide
(e.g. smollm's 9 heads on a 16-way model axis) falls back to replication for
that axis, and the decision is logged.  :func:`placements` turns a layout
into DTensor placements on a mesh.

The reference stacks each segment's layers and scans them; the port keeps
parameters per layer (``models.builder.LMParams``), so a segment leaf's
layout is the reference's stacked layout without its leading layer entry.
The rules are evaluated on the stacked shape (the FSDP threshold counts the
whole stack, as the reference's does); two of the reference's choices fall
on that layer entry and have no per-layer counterpart:

* its rank-3 rule for attention's ``wo`` meets the SSD block's stacked
  ``(L, din, d)`` ``wo`` (mamba2-780m) and puts ``model`` on the layer axis;
  the per-layer layout is the rest of that spec (logged);
* ZeRO-1 (:func:`opt_shardings`) shards a moment's first replicated
  divisible dim over ``data``, which for a stacked leaf is the layer axis
  whenever the depth divides the data axis; per layer, the port takes the
  first such dim of the layer's own shape instead, so a moment holds the
  same share of bytes per chip.

A mesh is a ``DeviceMesh`` with ``mesh_dim_names``, or (for the rules alone,
which only read axis sizes) a mapping of axis name to size.
:func:`mesh_context` lets the forward's own plain tensors (masks, rope
tables, scalars, the MoE aux loss) meet DTensors as replicated values
(``implicit_replication``); :func:`constrain` redistributes a DTensor on its
own mesh and leaves a plain tensor as it is.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, \
    Tuple, Union

import torch

from repro_torch.kernels.flash_attention import register_k4_sharding

log = logging.getLogger(__name__)

MESH_AXES = ("pod", "data", "model")

Layout = Tuple[Any, ...]
MeshLike = Union[Mapping[str, int], Any]

def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh: MeshLike, name: str) -> int:
    return int(mesh_shape(mesh).get(name, 1))


def _fit(dim: int, mesh: MeshLike, axis: str) -> Optional[str]:
    """Return the axis if dim divides its size, else None (replicate)."""
    if dim % _axis_size(mesh, axis) == 0:
        return axis
    log.info("sharding fallback: dim %d !%% %s=%d -> replicated",
             dim, axis, _axis_size(mesh, axis))
    return None


def _spec_for(name: str, shape: Tuple[int, ...], mesh: MeshLike) -> Layout:
    """The reference's rule for a leaf called ``name`` of ``shape``."""
    m = "model"
    if name in ("embed",):                       # (V, d)
        return (_fit(shape[0], mesh, m), None)
    if name in ("head",):                        # (d, V)
        return (None, _fit(shape[1], mesh, m))
    if name == "wq":                             # (d, H, hd)
        return (None, _fit(shape[1], mesh, m), None)
    if name in ("wk", "wv"):                     # (d, KV, hd)
        return (None, _fit(shape[1], mesh, m), None)
    if name == "wo":                             # (H, hd, d)
        return (_fit(shape[0], mesh, m), None, None)
    if name in ("wg", "wu"):
        if len(shape) == 3:                      # MoE experts (E, d, f)
            return (_fit(shape[0], mesh, m), None, None)
        return (None, _fit(shape[1], mesh, m))   # dense (d, f)
    if name == "wd":
        if len(shape) == 3:                      # (E, f, d)
            return (_fit(shape[0], mesh, m), None, None)
        return (_fit(shape[0], mesh, m), None)   # (f, d)
    if name == "router":                         # (d, E)
        return (None, _fit(shape[1], mesh, m))
    if name in ("wx",):                          # ssd (d, 2*din)
        return (None, _fit(shape[1], mesh, m))
    if name in ("wdt",):                         # (d, H)
        return (None, _fit(shape[1], mesh, m))
    if name in ("dt_bias", "a_log"):             # (H,)
        return (_fit(shape[0], mesh, m),)
    if name in ("wbc",):                         # (d, 2N) -- small, replicate
        return (None, None)
    if name in ("w_in", "w_gate", "w_r", "w_i"):  # lru (d|dr, dr)
        return (None, _fit(shape[1], mesh, m))
    if name in ("b_r", "b_i", "lam"):            # (dr,)
        return (_fit(shape[0], mesh, m),)
    if name in ("w_out", "wo2"):                 # (dr|din, d)
        return (_fit(shape[0], mesh, m), None)
    # norms, biases, everything else: replicate
    return (None,) * len(shape)


def _rule_rank(name: str) -> Optional[int]:
    ranks = {
        "embed": 2, "head": 2, "wq": 3, "wk": 3, "wv": 3, "wo": 3,
        "router": 2, "wx": 2, "wdt": 2, "dt_bias": 1, "a_log": 1, "wbc": 2,
        "w_in": 2, "w_gate": 2, "w_r": 2, "w_i": 2, "b_r": 1, "b_i": 1,
        "lam": 1, "w_out": 2,
    }
    return ranks.get(name)


def _leaves(params) -> Iterator[Tuple[str, torch.Tensor, Optional[int],
                                     bool]]:
    """(parameter name, tensor, layers stacked in the reference's leaf (None
    outside the segments), whether it lies in an ``moe`` block) for every
    parameter of an ``LMParams``."""
    for name, p in params.named_parameters():
        parts = name.split(".")
        n_stack = None
        if parts[0] in ("segments", "enc_segments"):
            n_stack = len(getattr(params, parts[0])[int(parts[1])])
        yield name, p, n_stack, any("moe" in part for part in parts[:-1])


def _stacked_spec(leaf: str, shape: Tuple[int, ...], moe: bool,
                  mesh: MeshLike, fsdp: bool, fsdp_min_elems: int
                  ) -> List[Any]:
    """The reference's ``param_shardings_stacked`` rule for one leaf of the
    (stacked) ``shape``."""
    d = _axis_size(mesh, "data")
    rr = _rule_rank(leaf)
    if leaf in ("wg", "wu", "wd"):
        # disambiguate dense (2) vs moe (3) by the segment kind in the path
        rr = 3 if moe else 2
    if rr is None or rr > len(shape):
        rr = len(shape)
    spec = [None] * (len(shape) - rr) + list(
        _spec_for(leaf, shape[len(shape) - rr:], mesh))
    if fsdp and math.prod(shape) >= fsdp_min_elems and d > 1:
        for i in range(len(shape) - rr, len(shape)):
            if spec[i] is None and shape[i] % d == 0 and shape[i] >= d:
                spec[i] = "data"
                break
    return spec


def param_shardings_stacked(params, mesh: MeshLike, fsdp: bool = False,
                            fsdp_min_elems: int = 1 << 20
                            ) -> Dict[str, Layout]:
    """Parameter name -> layout for every parameter of ``params`` (an
    ``LMParams``, real or fake): the reference's rule resolved on the
    trailing ``rule_rank`` dims of the stacked leaf, without the layer
    entry.

    ``fsdp=True`` additionally shards the first still-replicated divisible
    dim of every large leaf (``fsdp_min_elems`` counted over the stack) over
    ``data`` (FSDP / ZeRO-3 weight sharding: DTensor all-gathers a weight
    where a product needs it whole)."""
    out = {}
    for name, p, n_stack, moe in _leaves(params):
        leaf = name.split(".")[-1]
        shape = tuple(p.shape)
        if n_stack is None:
            out[name] = tuple(_stacked_spec(leaf, shape, moe, mesh, fsdp,
                                            fsdp_min_elems))
            continue
        spec = _stacked_spec(leaf, (n_stack,) + shape, moe, mesh, fsdp,
                             fsdp_min_elems)
        if spec[0] is not None:
            log.info("sharding: %s's stacked layer axis over %s has no "
                     "per-layer counterpart -> %s", name, spec[0], spec[1:])
        out[name] = tuple(spec[1:])
    return out


def param_shardings(params, mesh: MeshLike) -> Dict[str, Layout]:
    """Parameter name -> layout, without FSDP.  Each port parameter is one
    layer's, so the rule always addresses its own shape."""
    return param_shardings_stacked(params, mesh, fsdp=False)


def batch_axes_for(global_batch: int, mesh: MeshLike) -> Tuple[str, ...]:
    """Best batch sharding: ("pod","data") -> ("data",) -> () by
    divisibility."""
    shape = mesh_shape(mesh)
    pd = _axis_size(mesh, "pod") * _axis_size(mesh, "data")
    if global_batch % pd == 0:
        return tuple(a for a in ("pod", "data") if a in shape)
    d = _axis_size(mesh, "data")
    if global_batch % d == 0 and "data" in shape:
        return ("data",)
    return ()


def batch_shardings(batch_shape: Mapping[str, Any], mesh: MeshLike,
                    global_batch: int) -> Dict[str, Layout]:
    """Input name -> layout: the leading (batch) dim over
    :func:`batch_axes_for`, the rest replicated."""
    axes = batch_axes_for(global_batch, mesh)
    spec_axes = axes if axes else None
    return {k: (spec_axes,) + (None,) * (len(v.shape) - 1)
            for k, v in batch_shape.items()}


def opt_shardings(param_sharding: Mapping[str, Layout], params,
                  mesh: MeshLike, zero1: bool = False) -> Dict[str, Layout]:
    """Optimizer-moment layouts by parameter name.  With ``zero1``, a
    moment additionally shards its first still-replicated, divisible dim
    over "data" (ZeRO-1-style optimizer-state partitioning); the layer's
    own dims, as the module docstring says."""
    if not zero1:
        return dict(param_sharding)
    d = _axis_size(mesh, "data")
    shapes = {name: tuple(p.shape) for name, p in params.named_parameters()}
    out = {}
    for name, sh in param_sharding.items():
        shape = shapes[name]
        spec = list(sh) + [None] * (len(shape) - len(sh))
        if "data" not in spec:  # already data-sharded (e.g. FSDP weights)
            for i, (s, dim) in enumerate(zip(spec, shape)):
                if s is None and dim % d == 0 and dim >= d:
                    spec[i] = "data"
                    break
        out[name] = tuple(spec)
    return out


# ---------------------------------------------------------------------------
# meshes, placements, the mesh context
# ---------------------------------------------------------------------------

def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the default process group, on ``device_type``
    (``cuda`` by default; ``cpu`` for a gloo or fake process group on the
    host).  The process group must be initialised."""
    from torch.distributed.device_mesh import DeviceMesh
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass "
                           "device_type='cpu' for a mesh on the host")
    ranks = torch.arange(math.prod(shape), dtype=torch.int).reshape(
        tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def placements(layout: Layout, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``layout`` on ``mesh``, one per mesh dim:
    ``Shard(i)`` where tensor dim ``i`` names that axis (alone or in a
    tuple, major axis first), ``Replicate()`` elsewhere.  Axes the mesh
    lacks are dropped, as the reference's ``constrain`` drops them."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, entry in enumerate(layout)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        if len(dims) > 1:
            raise ValueError(f"layout {layout}: axis {axis!r} shards "
                             f"dims {dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(t: torch.Tensor, layout: Layout, mesh):
    """``t`` (the whole value, on every rank) as a DTensor laid out as
    ``layout``: each rank keeps its shard; nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor
    _dtensor_ready()
    return distribute_tensor(t, mesh, placements(layout, mesh),
                             src_data_rank=None)


@functools.cache
def _dtensor_ready() -> None:
    """Give DTensor K4's sharding rule, once a process, before the port's
    first DTensor (``torch.distributed.tensor`` takes over a second to
    import, so processes that never shard do not)."""
    register_k4_sharding()


def distribute_params(params, layouts: Mapping[str, Layout], mesh) -> None:
    """Replace every parameter of ``params`` (an ``nn.Module``) by a DTensor
    parameter laid out as ``layouts[name]``."""
    for name, p in list(params.named_parameters()):
        *path, leaf = name.split(".")
        owner = params.get_submodule(".".join(path)) if path else params
        new = torch.nn.Parameter(distribute(p.detach(), layouts[name], mesh),
                                 requires_grad=p.requires_grad)
        if isinstance(owner, torch.nn.ParameterDict):
            owner[leaf] = new
        else:
            setattr(owner, leaf, new)


def gathered(t):
    """``t`` whole over the data-parallel axes (``pod``, ``data``), as FSDP
    gathers a weight before it computes with it; its other placements
    kept.  The identity on a plain tensor and where nothing is
    data-sharded."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    want = tuple(Replicate() if name in ("pod", "data") else p for name, p
                 in zip(t.device_mesh.mesh_dim_names, t.placements))
    return t if tuple(t.placements) == want else t.redistribute(
        t.device_mesh, want)


def keep_shards(t, dims: Sequence[int]):
    """DTensor ``t`` with its shards of ``dims`` kept and every other
    placement made whole (``Replicate``)."""
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(p if isinstance(p, Shard) and p.dim in dims else
                 Replicate() for p in t.placements)
    return t if tuple(t.placements) == want else t.redistribute(
        t.device_mesh, want)


def set_data(p: torch.Tensor, t: torch.Tensor) -> None:
    """``p.data = t``, for DTensor parameters too: their ``.data`` setter
    changes the wrapper's type but leaves the old local shard, so a DTensor
    ``p`` takes ``t``'s contents whole (``torch.utils.swap_tensors``; every
    holder of ``p`` sees them)."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        torch.utils.swap_tensors(p, torch.nn.Parameter(
            t, requires_grad=p.requires_grad))
    else:
        p.data = t


def relayout(tensors: Sequence[torch.Tensor], layouts: Sequence[Layout],
             mesh) -> List[torch.Tensor]:
    """Each DTensor of ``tensors`` redistributed to its layout where its
    placements differ (the same object where they do not)."""
    out = []
    for t, lay in zip(tensors, layouts):
        want = placements(lay, mesh)
        out.append(t if tuple(t.placements) == want
                   else t.redistribute(mesh, want))
    return out


@contextlib.contextmanager
def mesh_context(mesh):
    """Run the model on ``mesh``'s DTensors: plain tensors that the forward
    makes (masks, rope tables, scalars, the MoE aux loss) meet DTensors as
    replicated values (``implicit_replication``).  :func:`constrain` needs
    no more than its argument's own mesh: a layer that remat recomputes in
    the backward runs on the autograd engine's device thread, which sees
    no context of this one."""
    from torch.distributed.tensor.experimental import implicit_replication
    _dtensor_ready()
    with implicit_replication():
        yield mesh


def constrain(x, *axes):
    """Activation sharding constraint by logical axes; the identity on a
    plain tensor (there is no mesh).  ``axes`` entries are mesh axis names,
    tuples, or None; a DTensor is redistributed to that layout on its mesh
    (dims not named are replicated, as in the reference; axes the mesh
    lacks are dropped)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = set(mesh.mesh_dim_names)

    def ok(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            sub = tuple(x_ for x_ in a if x_ in names)
            return sub if sub else None
        return a if a in names else None

    want = placements(tuple(ok(a) for a in axes), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


class _ContiguousGrad(torch.autograd.Function):
    """The identity whose backward makes the gradient contiguous: a shard's
    gradient leaves ``to_local`` for a DTensor whose global strides DTensor
    infers from the shard's, and later views of it rely on them."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_shard(t: DTensor) -> torch.Tensor:
    """``t``'s local shard, its gradient made contiguous."""
    return _ContiguousGrad.apply(t.to_local())


def take_rows(table, idx):
    """``table[idx]`` (rows of a 2-D table).  On DTensors it runs on each
    rank's shards: the table gathered whole but for its row shards; where
    it is row-sharded (a vocab), each rank takes the rows its shard holds
    (zeros elsewhere) and they are summed over the axis (``Partial``), as
    Megatron's vocab-parallel embedding does; an index past the table takes
    zeros.  DTensor's own
    ``aten.index`` gathers the indices' batch instead, and its
    ``index_put`` backward fails on some releases."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[idx]
    mesh = table.device_mesh
    rowwise = [p == Shard(0) for p in table.placements]
    local = local_shard(table.redistribute(mesh, [
        Shard(0) if v else Replicate() for v in rowwise]))
    idx_lay = [Replicate() if v or p != Shard(0) else p
               for v, p in zip(rowwise, idx.placements)]
    ids = idx.redistribute(mesh, idx_lay).to_local()
    first, _ = shard_range(table.shape[0], mesh, rowwise)
    held = (ids >= first) & (ids < first + local.shape[0])
    rows = local[torch.where(held, ids - first, 0)]
    rows = rows * held[..., None].to(rows.dtype)
    out_lay = [Partial() if v else p for v, p in zip(rowwise, idx_lay)]
    shape = (*idx.shape, table.shape[1])
    return DTensor.from_local(rows.contiguous(), mesh, out_lay,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def shard_range(size: int, mesh, sharded) -> Tuple[int, int]:
    """(first, count): this rank's rows of a dim of ``size`` sharded
    (``torch.chunk``'s split) over the mesh dims where ``sharded``."""
    first = 0
    coord = mesh.get_coordinate()
    for i, on in enumerate(sharded):
        if on:
            chunk = -(-size // mesh.size(i))
            first += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return first, size


def scatter_rows(n_rows: int, idx, src, passes: int = 1):
    """``zeros(n_rows, d).index_add(0, idx[:, k], src)`` for each column k
    of ``idx`` (``passes`` of them), in turn.  On DTensors each rank adds
    its shard of ``src``'s rows into a whole table of its own, and the
    tables are summed over the axes that shard the rows (``Partial``):
    DTensor's ``index_add`` mixes local and global sizes on some
    releases."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(src, DTensor):
        out = src.new_zeros((n_rows, src.shape[1]))
        for k in range(passes):
            out = out.index_add(0, idx[:, k], src)
        return out
    mesh = src.device_mesh
    lay = [p if p == Shard(0) else Replicate() for p in src.placements]
    x = local_shard(src.redistribute(mesh, lay))
    ids = idx.redistribute(mesh, lay).to_local()
    out = x.new_zeros((n_rows, x.shape[1]))
    for k in range(passes):
        out = out.index_add(0, ids[:, k], x)
    return DTensor.from_local(
        out, mesh, [Partial() if p == Shard(0) else Replicate() for p in lay],
        run_check=False, shape=(n_rows, src.shape[1]),
        stride=(src.shape[1], 1))


def einsum(equation: str, *operands):
    """``torch.einsum``; on DTensors, run on each rank's shards.  DTensor
    cannot shard ``einsum`` itself: it decomposes into ``aten.bmm`` on
    flattened dims, and a flattened dim that holds a shard has no bmm
    strategy.  Per mesh dim, the first label an operand shards there is
    sharded in every operand that has it (the others are replicated there);
    the result is sharded on that label, or partial (a sum) where the
    equation contracts it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not any(isinstance(t, DTensor) for t in operands):
        return torch.einsum(equation, *operands)
    ins, out = equation.replace(" ", "").split("->")
    specs = ins.split(",")
    mesh = next(t for t in operands if isinstance(t, DTensor)).device_mesh
    labels = []
    for i in range(mesh.ndim):
        label = None
        for spec, t in zip(specs, operands):
            p = t.placements[i] if isinstance(t, DTensor) else Replicate()
            if isinstance(p, Shard):
                label = spec[p.dim]
                break
        labels.append(label)
    local = []
    for spec, t in zip(specs, operands):
        want = [Shard(spec.index(lab)) if lab is not None and lab in spec
                else Replicate() for lab in labels]
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(local_shard(t.redistribute(mesh, want)))
    res = torch.einsum(equation, *local).contiguous()
    placed = [Replicate() if lab is None else
              Shard(out.index(lab)) if lab in out else Partial()
              for lab in labels]
    sizes = {}
    for spec, t in zip(specs, operands):
        sizes.update(zip(spec, t.shape))
    shape = tuple(sizes[c] for c in out)
    return DTensor.from_local(res, mesh, placed, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())
