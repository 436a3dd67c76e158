"""The port's meshed training (``repro_torch.launch.train.
build_sharded_train``) on a world of one CPU rank (gloo), against the
reference's ``build_sharded_train`` and against the port's unmeshed step.

* The meshed step against the reference's jitted sharded step on a (1, 1)
  mesh: smollm-135m at reduced width from the reference's weights (carried
  over by ``repro_torch.models.convert``), 3 steps of 2 x 32 tokens, FSDP
  and ZeRO-1 on (and ``int8`` compression), the loss at
  ``tests/test_torch_train.py``'s float32 tolerances (1e-4 relative, 2e-3
  under ``int8``).
* The meshed ``train`` against the unmeshed one: losses and every
  parameter, moment and residual equal bit for bit (on one rank each shard
  is the whole tensor, and the step dispatches the same ops).
* The CLI trains on the host mesh and leaves no process group behind.
* The sharded forward computes the unmeshed values: four gloo processes on
  a (2, 2) mesh, five reduced archs (dense, MoE, SSD, RG-LRU hybrid,
  encoder-decoder), the loss, the prefill logits and a decode step's logits
  to 1e-5 relative.

Each test starts a gloo world (of one rank, or four spawned processes) and
destroys it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro.launch.train as ref_train
from repro.configs import get_arch as ref_get_arch
from repro.data import TokenPipeline
from repro.distributed.sharding import make_mesh as ref_make_mesh
from repro.distributed.sharding import mesh_context as ref_mesh_context
from repro.models import builder as RB
from repro.optimizer import init_error_feedback as ref_init_ef
from repro_torch.configs import get_arch
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import builder as PB
from repro_torch.models.convert import params_from_reference

ARCH, B, S, STEPS = "smollm-135m", 2, 32, 3


@pytest.fixture
def host_mesh():
    assert not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("fsdp,zero1", [(True, True), (False, False)])
def test_meshed_step_matches_the_reference(host_mesh, fsdp, zero1):
    mode, tol = None, 1e-4
    rcfg, pcfg = ref_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    rmodel, pmodel = RB.build_model(rcfg), PB.build_model(pcfg)
    rparams = RB.init_params(rmodel, jax.random.PRNGKey(0))
    pparams = params_from_reference(pmodel, jax.tree.map(np.asarray,
                                                         rparams))
    tc_r = ref_train.TrainConfig(steps=STEPS, lr=3e-3, warmup=2,
                                 grad_compress=mode, zero1=zero1, fsdp=fsdp)
    tc_p = port_train.TrainConfig(steps=STEPS, lr=3e-3, warmup=2,
                                  grad_compress=mode, zero1=zero1, fsdp=fsdp)
    pipe = TokenPipeline(vocab=rcfg.vocab, seq_len=S, batch_size=B)
    sample = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in pipe.next_batch().items()}
    pipe.restore({"step": 0, "seed": pipe.seed, "rank": 0, "world": 1})
    rmesh = ref_make_mesh((1, 1), ("data", "model"))
    with ref_mesh_context(rmesh):
        rfn, rsh = ref_train.build_sharded_train(rmodel, rmesh, tc_r, sample)
        rstate = rsh["optd"].init(rparams)
        ref_ef = ref_init_ef(rparams) if mode else None
    pfn, psh = port_train.build_sharded_train(
        pmodel, host_mesh, tc_p,
        {k: torch.empty(v.shape, dtype=torch.int64, device="meta")
         for k, v in sample.items()})
    plist = list(pparams.parameters())
    pstate = psh["optd"].init(plist)
    pef = port_train.init_error_feedback(plist) if mode else None
    pparams, pstate, pef = psh["place"](pparams, pstate, pef)
    assert all(isinstance(p, DTensor) for p in pparams.parameters())
    assert all(isinstance(m, DTensor) for m in pstate.mu + pstate.nu)
    for step in range(STEPS):
        tokens = pipe.next_batch()["tokens"]
        with ref_mesh_context(rmesh):
            rparams, rstate, ref_ef, rmet = rfn(
                rparams, rstate, ref_ef, {"tokens": jnp.asarray(tokens)},
                jnp.asarray(step, jnp.int32))
        pparams, pstate, pef, pmet = pfn(
            pparams, pstate, pef, {"tokens": torch.from_numpy(tokens).long()},
            step)
        rloss, ploss = float(rmet["loss"]), float(pmet["loss"])
        assert abs(ploss - rloss) <= tol * abs(rloss), (step, ploss, rloss)
    # the state keeps its layouts
    for (name, p) in pparams.named_parameters():
        assert isinstance(p, DTensor), name


@pytest.mark.parametrize("kw", [dict(fsdp=True, zero1=True),
                                dict(grad_compress="int8", zero1=True)])
def test_meshed_train_equals_the_unmeshed_bit_for_bit(host_mesh, kw):
    tc = port_train.TrainConfig(steps=STEPS, **kw)
    a = port_train.train(ARCH, tc, batch=B, seq=S, reduced=True,
                         device="cpu")
    b = port_train.train(ARCH, tc, batch=B, seq=S, reduced=True,
                         device="cpu", mesh=host_mesh)
    assert a.losses == b.losses
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert isinstance(y, DTensor) and x.dtype == y.dtype
        assert torch.equal(x, y.full_tensor())
    for xs, ys in ((a.opt_state.mu, b.opt_state.mu),
                   (a.opt_state.nu, b.opt_state.nu),
                   (a.ef_state.residual if a.ef_state else [],
                    b.ef_state.residual if b.ef_state else [])):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert torch.equal(x, y.full_tensor())


def test_meshed_checkpoint_round_trip(host_mesh, tmp_path):
    tc = port_train.TrainConfig(steps=4, checkpoint_every=2,
                                checkpoint_dir=str(tmp_path), fsdp=True)
    a = port_train.train(ARCH, tc, batch=B, seq=S, reduced=True,
                         device="cpu", mesh=host_mesh)
    b = port_train.train(ARCH, tc, batch=B, seq=S, reduced=True,
                         device="cpu", mesh=host_mesh, resume=True)
    assert b.start == 4 and not b.losses
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert isinstance(y, DTensor) and y.placements == x.placements
        assert torch.equal(x.full_tensor(), y.full_tensor())


def test_cli_trains_on_the_host_mesh(capsys):
    assert not dist.is_initialized()
    port_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch",
                     "2", "--seq", "16", "--zero1", "--device", "cpu"])
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "step     1 loss=" in out


FOUR_RANK_ARCHS = ("smollm-135m", "qwen3-moe-235b-a22b", "mamba2-780m",
                   "recurrentgemma-9b", "seamless-m4t-medium")


def _four_rank_values(arch: str, mesh) -> dict:
    """The reduced ``arch``'s loss, prefill logits and a decode step's
    logits, unmeshed and on ``mesh`` (FSDP layouts; the decode step from
    the unmeshed prefill's caches laid out by ``decode_state_shardings``)."""
    import copy

    from repro_torch.distributed import sharding as S
    from repro_torch.launch.dryrun import (decode_state_shardings,
                                           distribute_tree)
    cfg = get_arch(arch).reduced()
    model = PB.build_model(cfg)
    params = PB.init_params(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))
    batch = {"tokens": tokens}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (4, 8, cfg.d_model))).float()
    with torch.no_grad():
        loss = PB.train_loss(model, params, batch)[0]
        logits, states = PB.prefill(model, params, batch, max_len=17)
        kept = copy.deepcopy(states)
        step, _ = PB.decode(model, params, states, tokens[:, -1:], 16)
    S.distribute_params(params, S.param_shardings_stacked(
        params, mesh, fsdp=True), mesh)
    lay = S.batch_shardings(batch, mesh, 4)
    with S.mesh_context(mesh), torch.no_grad():
        dbatch = {k: S.distribute(v, lay[k], mesh) for k, v in batch.items()}
        mloss = PB.train_loss(model, params, dbatch)[0]
        mlogits, _ = PB.prefill(model, params, dbatch)
        mstates = distribute_tree(kept, decode_state_shardings(
            model, kept, mesh, 4), mesh)
        mstep, _ = PB.decode(model, params, mstates, S.distribute(
            tokens[:, -1:], lay["tokens"], mesh), 16)
    return {"loss": float(loss), "mloss": float(mloss.full_tensor()),
            "logits": logits.tolist(),
            "mlogits": mlogits.full_tensor().tolist(),
            "step": step.tolist(), "mstep": mstep.full_tensor().tolist()}


def _four_rank_worker(rank: int, port: int, out: str) -> None:
    """One of four gloo ranks on a (2, 2) mesh: every arch of
    ``FOUR_RANK_ARCHS``' values, written by rank 0."""
    import json

    import torch.distributed as dist

    from repro_torch.distributed import sharding as S
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = S.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        res = {arch: _four_rank_values(arch, mesh)
               for arch in FOUR_RANK_ARCHS}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_rank_values(tmp_path_factory):
    """Four spawned gloo processes, once for the module."""
    import json
    import multiprocessing
    import socket
    ctx = multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path_factory.mktemp("four_ranks") / "res.json")
    procs = [ctx.Process(target=_four_rank_worker, args=(r, port, out))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=400)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", FOUR_RANK_ARCHS)
def test_four_ranks_compute_the_unmeshed_values(arch, four_rank_values):
    """The sharded forward is the same function: four gloo processes on a
    (2, 2) mesh give the unmeshed loss, prefill logits and decode-step
    logits (float32, to 1e-5 relative: partial sums are added across ranks
    in another order)."""
    res = four_rank_values[arch]
    assert abs(res["mloss"] - res["loss"]) <= 1e-5 * abs(res["loss"])
    for key in ("logits", "step"):
        got, want = np.array(res["m" + key]), np.array(res[key])
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
