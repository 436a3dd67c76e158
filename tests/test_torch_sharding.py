"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), which imports jax but sets
no flags, so it is imported here directly; the reference's meshes are
``jax.sharding.AbstractMesh``es of the production shapes, the port's the
same axis sizes.

Every parameter of the ten archs at full width (the port's shapes from a
``FakeTensorMode`` init, the reference's from ``jax.eval_shape``), without
and with FSDP, and every moment under ZeRO-1: a leaf of a segment is one
stacked leaf in the reference and one tensor per layer in the port, whose
layout is the reference's without its layer entry.  Two of the reference's
choices fall on that entry (``sharding``'s docstring): mamba2-780m's SSD
``wo`` gets ``model`` there, and ZeRO-1 gets ``data`` there whenever the
depth divides the data axis; the port's ZeRO-1 then shards the first
per-layer dim the reference's loop would take.  The decode-state layouts
come from the reference's ``repro.launch.dryrun``, which sets ``XLA_FLAGS``
to 512 host devices when imported, so they are computed in a subprocess.
"""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.distributed.sharding as RS
from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro.models import init_params as ref_init_params
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.models import build_model, init_params
from repro_torch.models.builder import init_decode_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"single_pod_16x16": ((16, 16), ("data", "model")),
          "multi_pod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec):
    """A layout with one-axis tuples as the axis (jax normalises them)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _abstract(mesh_name):
    shape, axes = MESHES[mesh_name]
    return AbstractMesh(shape, axes)


def _sizes(mesh_name):
    shape, axes = MESHES[mesh_name]
    return dict(zip(axes, shape))


_PORT = {}


def _port_params(arch):
    if arch not in _PORT:
        with FakeTensorMode():
            _PORT[arch] = init_params(build_model(get_arch(arch)),
                                      torch.Generator().manual_seed(0))
    return _PORT[arch]


def _ref_shapes(arch):
    model = ref_build_model(ref_get_arch(arch))
    return jax.eval_shape(lambda k: ref_init_params(model, k),
                          jax.random.PRNGKey(0))


def _ref_by_key(tree):
    """Reference leaf path -> spec (a tuple)."""
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(e, "key", getattr(e, "idx", None)) for e in path)
        out[key] = tuple(sh.spec)
    return out


def _ref_key(name):
    """The reference leaf a port parameter belongs to."""
    parts = name.split(".")
    if parts[0] in ("segments", "enc_segments"):
        return (parts[0], int(parts[1]), parts[3], parts[4])
    return tuple(parts)


def _no_repeated_axis(layout):
    axes = [a for e in layout if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    return len(axes) == len(set(axes))


def _zero1_per_layer(spec, shape, d):
    """The reference's ZeRO-1 loop over a layer's own dims."""
    spec = list(spec)
    if "data" not in spec:
        for i, (s, dim) in enumerate(zip(spec, shape)):
            if s is None and dim % d == 0 and dim >= d:
                spec[i] = "data"
                break
    return tuple(spec)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_moment_layouts_equal_the_reference(arch, mesh_name):
    params = _port_params(arch)
    ref_shapes = _ref_shapes(arch)
    amesh, sizes = _abstract(mesh_name), _sizes(mesh_name)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert sum(p.numel() for p in params.parameters()) == sum(
        int(x.size) for x in jax.tree_util.tree_leaves(ref_shapes))
    layer_axis = set()
    for fsdp in (False, True):
        ref_p = _ref_by_key(RS.param_shardings_stacked(ref_shapes, amesh,
                                                       fsdp=fsdp))
        ref_o = _ref_by_key(RS.opt_shardings(
            RS.param_shardings_stacked(ref_shapes, amesh, fsdp=fsdp),
            ref_shapes, amesh, zero1=True))
        port_p = S.param_shardings_stacked(params, sizes, fsdp=fsdp)
        port_o = S.opt_shardings(port_p, params, sizes, zero1=True)
        assert set(port_p) == set(shapes) == set(port_o)
        for name, lay in port_p.items():
            key = _ref_key(name)
            want = _norm(ref_p[key])
            stacked = key[0] in ("segments", "enc_segments")
            if stacked:
                if want[0] is not None:
                    layer_axis.add((name.split(".")[3], key[-1], want[0]))
                want = want[1:]
            assert _norm(lay) == want, (name, fsdp)
            assert len(lay) == len(shapes[name]) and _no_repeated_axis(lay)
            # ZeRO-1
            want_o = _norm(ref_o[key])
            if stacked:
                if want_o[0] is None or want_o[0] == _norm(ref_p[key])[0]:
                    want_o = want_o[1:]
                else:   # the reference's ZeRO-1 took the layer axis
                    assert want_o[0] == "data"
                    want_o = _zero1_per_layer(want, shapes[name],
                                              sizes["data"])
            assert _norm(port_o[name]) == want_o, (name, fsdp)
            assert _no_repeated_axis(port_o[name])
        assert S.param_shardings(params, sizes) == \
            S.param_shardings_stacked(params, sizes, fsdp=False)
    # the reference puts an axis on the layer entry only for mamba2's SSD wo
    assert layer_axis <= {("b0_ssd", "wo", "model")}
    assert bool(layer_axis) == (arch == "mamba2-780m")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@settings(max_examples=300, deadline=None, derandomize=True)
@given(n=st.integers(1, 4096))
def test_batch_axes_equal_the_reference(mesh_name, n):
    amesh, sizes = _abstract(mesh_name), _sizes(mesh_name)
    assert S.batch_axes_for(n, sizes) == RS.batch_axes_for(n, amesh)
    batch = {"tokens": torch.empty((n, 8), device="meta"),
             "frames": torch.empty((n, 4, 16), device="meta")}
    ref = RS.batch_shardings(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.float32)
         for k, v in batch.items()}, amesh, n)
    port = S.batch_shardings(batch, sizes, n)
    assert {k: _norm(v) for k, v in port.items()} == \
        {k: _norm(tuple(v.spec)) + (None,) * (batch[k].dim()
                                                - len(v.spec))
         for k, v in ref.items()}


_REF_DECODE = r"""
import json, sys
import jax
from jax.sharding import AbstractMesh
import repro.launch.dryrun as d
from repro.configs import ARCHS, SHAPES, get_arch
from repro.models import build_model
from repro.models.builder import init_decode_state
out = {}
for mesh_name, (shape, axes) in json.loads(sys.argv[1]).items():
    mesh = AbstractMesh(tuple(shape), tuple(axes))
    for arch in sorted(ARCHS):
        cfg = get_arch(arch)
        model = build_model(cfg)
        for sname, spec in SHAPES.items():
            if spec.kind != "decode":
                continue
            enc = max(spec.seq_len // 8, 8) if cfg.family == "audio" else 0
            st = jax.eval_shape(lambda: init_decode_state(
                model, None, spec.global_batch, spec.seq_len, enc_len=enc))
            sh = d.decode_state_shardings(model, st, mesh, spec.global_batch)
            rec = []
            for seg in sh:
                if seg is None:
                    rec.append(None)
                    continue
                rec.append({k: ([list(x.spec) for x in v]
                                if isinstance(v, tuple) else list(v.spec))
                            for k, v in seg.items()})
            out[f"{mesh_name}|{arch}|{sname}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_decode_layouts():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_DECODE,
                          json.dumps(MESHES)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _tupled(x):
    return tuple(tuple(e) if isinstance(e, list) else e for e in x)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_state_layouts_equal_the_reference(arch, mesh_name,
                                                  ref_decode_layouts):
    cfg = get_arch(arch)
    model = build_model(cfg)
    sizes = _sizes(mesh_name)
    for sname, spec in SHAPES.items():
        if spec.kind != "decode":
            continue
        enc = max(spec.seq_len // 8, 8) if cfg.family == "audio" else 0
        with FakeTensorMode():
            states = init_decode_state(model, spec.global_batch,
                                       spec.seq_len, enc_len=enc)
        port = D.decode_state_shardings(model, states, sizes,
                                        spec.global_batch)
        ref = ref_decode_layouts[f"{mesh_name}|{arch}|{sname}"]
        assert len(port) == len(ref)
        for seg, ref_seg, st_seg in zip(port, ref, states):
            assert (seg is None) == (ref_seg is None)
            if seg is None:
                continue
            for layer, st_layer in zip(seg, st_seg):
                assert set(layer) == set(ref_seg)
                for key, lay in layer.items():
                    want = ref_seg[key]
                    if isinstance(st_layer[key], tuple):
                        # (L, B, S, KV, hd) -> head-major (B, Hkv, S, D)
                        for got, w in zip(lay, want):
                            w = _norm(_tupled(w))
                            assert _norm(got) == (w[1], w[3], w[2], w[4])
                    else:
                        assert _norm(lay) == _norm(_tupled(want))[1:]


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert S.constrain(x, ("pod", "data"), None, "model") is x
    assert S.constrain(x, None, None, None) is x


def test_placements_of_layouts():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert S.placements((("pod", "data"), None, "model"), Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    assert S.placements((None, "data"), Mesh()) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        S.placements(("data", "data"), Mesh())
