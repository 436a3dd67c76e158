"""The port's checkpoint manager (``repro_torch.checkpoint``) and token
pipeline (``repro_torch.data``) against the reference's.

The cases of ``tests/test_checkpoint_data.py`` run on the port (the elastic
restore with shardings becomes a restore onto a device).  Then:
``TokenPipeline``'s batches equal the reference's byte for byte, over vocabs
below and above its 65,536-token cap, after ``state()``/``restore()`` in
either direction and across ranks; the two managers write the same layout
(directory and file names, leaf files byte for byte, the manifest's step,
leaf count, extra and checksums) for the same arrays, and both raise the
same errors on a corrupt leaf and on a template of another leaf count;
bf16 round-trips bit for bit; ``save_async`` snapshots at the call; an
``LMParams`` template is restored in place with the saved types.
Everything here is held exactly: no tolerance.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.data import TokenPipeline as RefTokenPipeline
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.models import builder as PB


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 8), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32)}}


# ---- the reference's cases, on the port ------------------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    p = _params()
    mgr.save(10, p, {"note": "x"})
    restored, extra = mgr.restore(_params(1))
    assert extra["note"] == "x"
    assert torch.equal(restored["a"], p["a"])
    assert torch.equal(restored["nested"]["b"], p["nested"]["b"])
    assert restored["nested"]["b"].dtype == torch.int32


def test_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _params())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    p = _params()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, p, {"step": s})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checksum_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    p = _params()
    path = mgr.save(5, p)
    leaf = os.path.join(path, "leaf_00000.npy")
    arr = np.load(leaf)
    arr.flat[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError):
        mgr.restore(p)


def test_restore_onto_a_device(tmp_path):
    """The reference re-shards on restore; the port places each tensor on
    ``device`` (here the CPU, from a template on the meta device)."""
    mgr = CheckpointManager(str(tmp_path))
    p = _params()
    mgr.save(7, p)
    template = {"a": torch.empty((8, 8), device="meta"),
                "nested": {"b": torch.empty(10, dtype=torch.int32,
                                            device="meta")}}
    restored, _ = mgr.restore(template, device="cpu")
    assert restored["nested"]["b"].device.type == "cpu"
    assert torch.equal(restored["nested"]["b"], p["nested"]["b"])
    assert torch.equal(restored["a"], p["a"])


def test_pipeline_exact_resume():
    a = TokenPipeline(vocab=1000, seq_len=32, batch_size=4, seed=3)
    [a.next_batch() for _ in range(5)]
    state = a.state()
    later = [a.next_batch() for _ in range(3)]

    b = TokenPipeline(vocab=1000, seq_len=32, batch_size=4, seed=3)
    b.restore(state)
    resumed = [b.next_batch() for _ in range(3)]
    for x, y in zip(later, resumed):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_pipeline_rank_disjoint():
    a = TokenPipeline(vocab=1000, seq_len=32, batch_size=4, seed=3, rank=0,
                      world=2)
    b = TokenPipeline(vocab=1000, seq_len=32, batch_size=4, seed=3, rank=1,
                      world=2)
    assert not np.array_equal(a.next_batch()["tokens"],
                              b.next_batch()["tokens"])


# ---- the pipeline against the reference's ---------------------------------

PIPES = [dict(vocab=1000, seq_len=32, batch_size=4, seed=3),
         dict(vocab=49152, seq_len=2048, batch_size=2),
         dict(vocab=128256, seq_len=100, batch_size=3, seed=7, rank=1,
              world=2),
         dict(vocab=512, seq_len=8, batch_size=5, seed=1, rank=3, world=4,
              motif_len=4, n_motifs=16)]


@pytest.mark.parametrize("kw", PIPES, ids=lambda kw: f"v{kw['vocab']}"
                         f"-s{kw['seq_len']}-r{kw.get('rank', 0)}")
def test_pipeline_batches_equal_the_reference(kw):
    port, ref = TokenPipeline(**kw), RefTokenPipeline(**kw)
    for _ in range(3):
        got, want = port.next_batch(), ref.next_batch()
        assert sorted(got) == sorted(want) == ["tokens"]
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        assert got["tokens"].tobytes() == want["tokens"].tobytes()
    assert port.state() == ref.state()
    # resume across the packages, both ways
    port2, ref2 = TokenPipeline(**kw), RefTokenPipeline(**kw)
    port2.restore(ref.state())
    ref2.restore(port.state())
    want = ref.next_batch()["tokens"].tobytes()
    assert port2.next_batch()["tokens"].tobytes() == want
    assert ref2.next_batch()["tokens"].tobytes() == want
    assert port.next_batch()["tokens"].tobytes() == want


def test_pipeline_restore_refuses_another_config():
    a = TokenPipeline(vocab=1000, seq_len=32, batch_size=4, seed=3)
    b = TokenPipeline(vocab=1000, seq_len=32, batch_size=4, seed=4)
    with pytest.raises(AssertionError):
        b.restore(a.state())


# ---- the manager against the reference's -----------------------------------

def _arrays():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "z": {"n": np.arange(7, dtype=np.int32),
                  "m": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


def _both(tmp_path, keep=3):
    ref = RefCheckpointManager(str(tmp_path / "ref"), keep=keep)
    port = CheckpointManager(str(tmp_path / "port"), keep=keep)
    return ref, port


def test_layout_equals_the_reference(tmp_path):
    arrays = _arrays()
    ref, port = _both(tmp_path)
    extra = {"step": 3, "pipeline": {"step": 3, "seed": 0, "rank": 0,
                                     "world": 1}}
    rpath = ref.save(3, jax.tree.map(jnp.asarray, arrays), extra)
    ppath = port.save(3, jax.tree.map(torch.from_numpy, arrays), extra)
    assert os.path.basename(rpath) == os.path.basename(ppath) \
        == "step_0000000003"
    assert sorted(os.listdir(rpath)) == sorted(os.listdir(ppath))
    with open(os.path.join(rpath, "manifest.json")) as f:
        rman = json.load(f)
    with open(os.path.join(ppath, "manifest.json")) as f:
        pman = json.load(f)
    for key in ("step", "n_leaves", "extra", "checksums"):
        assert rman[key] == pman[key], key
    assert pman["treedef"] == ["b", "w", "z.m", "z.n"]
    assert pman["dtypes"] == ["float32", "float32", "float32", "int32"]
    for i in range(rman["n_leaves"]):
        name = f"leaf_{i:05d}.npy"
        with open(os.path.join(rpath, name), "rb") as f:
            want = f.read()
        with open(os.path.join(ppath, name), "rb") as f:
            assert f.read() == want, name
    # each package restores the other's files
    rgot, rextra = ref.restore(jax.tree.map(jnp.asarray, arrays))
    pgot, pextra = port.restore(jax.tree.map(torch.from_numpy, arrays))
    assert rextra == pextra == extra
    for leaf_r, leaf_p in zip(jax.tree.leaves(rgot), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), pgot))):
        assert np.asarray(leaf_r).tobytes() == leaf_p.tobytes()


def test_gc_and_steps_equal_the_reference(tmp_path):
    arrays = _arrays()
    ref, port = _both(tmp_path, keep=2)
    for s in (5, 1, 9, 3):
        ref.save_async(s, jax.tree.map(jnp.asarray, arrays), {"s": s})
        port.save_async(s, jax.tree.map(torch.from_numpy, arrays), {"s": s})
    ref.wait()
    port.wait()
    assert port.all_steps() == ref.all_steps()
    assert port.latest_step() == ref.latest_step()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))


def test_errors_equal_the_reference(tmp_path):
    arrays = _arrays()
    ref, port = _both(tmp_path)
    rpath = ref.save(2, jax.tree.map(jnp.asarray, arrays))
    ppath = port.save(2, jax.tree.map(torch.from_numpy, arrays))
    short = {k: v for k, v in arrays.items() if k != "b"}
    with pytest.raises(ValueError):
        ref.restore(jax.tree.map(jnp.asarray, short))
    with pytest.raises(ValueError):
        port.restore(jax.tree.map(torch.from_numpy, short))
    for path in (rpath, ppath):
        leaf = os.path.join(path, "leaf_00001.npy")
        arr = np.load(leaf)
        arr.flat[3] = -arr.flat[3]
        np.save(leaf, arr)
    with pytest.raises(IOError):
        ref.restore(jax.tree.map(jnp.asarray, arrays))
    with pytest.raises(IOError):
        port.restore(jax.tree.map(torch.from_numpy, arrays))
    empty_ref, empty_port = _both(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        empty_ref.restore(jax.tree.map(jnp.asarray, arrays))
    with pytest.raises(FileNotFoundError):
        empty_port.restore(jax.tree.map(torch.from_numpy, arrays))


def test_restore_refuses_other_leaf_names(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3), "b": torch.ones(2)})
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.zeros(3), "c": torch.ones(2)})


def test_bf16_round_trips_bit_for_bit(tmp_path):
    """numpy has no bf16: the manager stores the bits as uint16, records the
    type and restores bf16, every bit pattern (NaNs and infinities too)."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).reshape(256, 256)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, {"x": x, "y": torch.ones(3)})
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["dtypes"] == ["bfloat16", "float32"]
    assert np.load(os.path.join(path, "leaf_00000.npy")).dtype == np.uint16
    got, _ = mgr.restore({"x": torch.zeros(256, 256), "y": torch.zeros(3)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def test_save_async_snapshots_at_the_call(tmp_path):
    """The train loop updates parameters in place right after
    ``save_async``: the checkpoint holds the values at the call."""
    mgr = CheckpointManager(str(tmp_path))
    p = {"w": torch.zeros(1000)}
    mgr.save_async(1, p)
    p["w"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore({"w": torch.empty(1000)})
    assert torch.equal(got["w"], torch.zeros(1000))


def test_wait_raises_on_a_failed_write(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def fail(*a):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write", fail)
    mgr.save_async(1, _params())
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()


def test_lm_params_restore_in_place_with_the_saved_types(tmp_path):
    """An ``LMParams`` is saved leaf by leaf in ``named_parameters()`` order
    and restored into a template in place: the same module back, every
    parameter the saved values and types (float32 into a bf16 template, as
    after the reference's first step)."""
    cfg = get_arch("llama3-8b").reduced()
    model = PB.build_model(cfg)
    saved = PB.init_params(model, torch.Generator().manual_seed(1))
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(4, saved, {"step": 4})
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["treedef"] == [n for n, _ in saved.named_parameters()]
    bf16 = PB.build_model(dataclasses.replace(cfg, dtype="bfloat16"))
    template = PB.init_params(bf16, torch.Generator().manual_seed(2))
    assert {p.dtype for p in template.parameters()} == {torch.bfloat16}
    got, extra = mgr.restore(template)
    assert got is template and extra == {"step": 4}
    want = dict(saved.named_parameters())
    for n, p in got.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, n
        assert torch.equal(p.detach(), want[n].detach()), n

