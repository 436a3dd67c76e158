"""The LM zoo's training half on the port against the reference, on the CPU:
gradient compression (``repro_torch.optimizer.grad_compress``), AdamW's
types, the straggler and re-mesh planners, ``make_train_step`` against the
reference's ``step_fn``, remat, and the ``repro_torch.launch.train`` CLI
against ``repro.launch.train``'s.  The cases of
``tests/test_distributed.py``'s optimizer, compression and fault-tolerance
tests run on the port too.

The train step: the same parameters (the reference's ``init_params`` at
``PRNGKey(0)``, carried over by ``repro_torch.models.convert``) and the
same ``TokenPipeline`` batches (2 x 32 tokens) for 5 steps at lr 3e-3 with
2 warmup steps, ``AdamW(weight_decay=0.1, clip_norm=1.0)``, on five text
archs at reduced width, with no compression, ``int8`` and ``topk``.  The
reference's step is jitted, except under ``topk`` (its ``topk_decompress``
cannot be traced): that step runs eagerly with its ``train_loss`` jitted.
Held after every step: every parameter's, moment's and residual's type,
exactly; the loss; the parameters.  ``hold_train_steps`` runs it; the
float32 cases are in ``test_torch_train_step.py``, the bf16 ones in
``test_torch_train_bf16.py``.  Tolerances (float32):

* loss: relative 1e-4 (measured at most 9.5e-6 without compression or
  under ``topk``), 2e-3 under ``int8`` (measured 6.3e-4): an entry whose
  ``grad / scale`` lies within rounding of a half quantum rounds the other
  way, Adam turns a one-quantum gradient into a step of about lr, and error
  feedback carries it on;
* parameters, in units of lr: max |port - reference| <= 2 x the sum of the
  steps' lr (each Adam step moves an entry by about lr at most, so an entry
  whose tiny gradient flips sign differs by up to twice that: measured 1.17
  x the sum); and the update, ||p_port - p_ref|| <= 5e-2 x ||p_ref - p_0||
  over all parameters (measured at most 2.0e-2, under ``int8``; an update
  computed wrongly is off by order 1).
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as ref_train
from repro.configs import get_arch as ref_get_arch
from repro.data import TokenPipeline
from repro.distributed import fault_tolerance as ref_ft
from repro.models import builder as RB
from repro.optimizer import AdamW as RefAdamW
from repro.optimizer import grad_compress as RG
from repro.optimizer import init_error_feedback as ref_init_ef
from repro.optimizer import linear_warmup_cosine as ref_lr
from repro_torch.configs import get_arch
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     plan_backup_dispatch,
                                                     plan_remesh)
from repro_torch.launch import train as port_train
from repro_torch.models import builder as PB
from repro_torch.models import layers as PL
from repro_torch.models.convert import params_from_reference
from repro_torch.optimizer import (AdamW, ErrorFeedbackState,
                                   compress_with_error_feedback,
                                   init_error_feedback, int8_compress,
                                   int8_decompress, linear_warmup_cosine,
                                   topk_compress, topk_decompress)

ARCHS = ("llama3-8b", "smollm-135m", "qwen3-moe-235b-a22b", "mamba2-780m",
         "recurrentgemma-9b")
MODES = (None, "int8", "topk")
B, S, STEPS, LR, WARMUP = 2, 32, 5, 3e-3, 2
#: float32 (loss relative, update relative) per mode; see the docstring
TOL = {None: (1e-4, 5e-2), "topk": (1e-4, 5e-2), "int8": (2e-3, 5e-2)}


def _t(x) -> torch.Tensor:
    """A numpy or JAX array (float32, bfloat16 or integer) as a tensor of
    the same type."""
    x = np.asarray(x)
    if str(x.dtype) == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _tname(t) -> str:
    return str(t.dtype).removeprefix("torch.")


# ---- gradient compression against the reference ---------------------------

def _draw(shape, dtype, seed=0, scale=3.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return jnp.asarray(x, dtype=jnp.dtype(dtype))


def _assert_int8_close(got, want, scale, dtype):
    """float32: equal.  bf16: ``x / scale`` is rounded to bf16 before
    ``round`` in the port (torch rounds every bf16 op), while XLA may keep
    the quotient in float32: an entry within that rounding of a half
    quantum lands one quantum away, never more."""
    diff = (got.double() - want.double()).abs()
    if dtype == "float32":
        assert float(diff.max()) == 0.0
    else:
        assert float(diff.max()) <= 1.0001 * scale
        assert float((diff > 0).double().mean()) <= 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (256,), (3, 64, 16)])
def test_int8_matches_the_reference(dtype, shape):
    x = _draw(shape, dtype)
    rq, rs = RG.int8_compress(x)
    pq, ps = int8_compress(_t(x))
    assert pq.dtype == torch.int8 and str(rq.dtype) == "int8"
    assert _tname(ps) == str(rs.dtype) == dtype
    assert float(ps) == float(rs)
    _assert_int8_close(pq, _t(rq), float(rs), dtype)
    ry, py = RG.int8_decompress(rq, rs), int8_decompress(pq, ps)
    assert str(ry.dtype) == _tname(py) == "float32"
    _assert_int8_close(py / float(rs), _t(ry) / float(rs), 1.0, dtype)


def _assert_topk_close(got, want, x, k, kept=True):
    """Equal but where the two top-k choices differ among ties: every entry
    that differs has the magnitude of the k-th largest.  ``kept``: ``got``
    holds the kept entries (at most k nonzero), not a residual."""
    x = x.double().reshape(-1)
    kth = torch.topk(x.abs(), k).values[-1]
    diff = (got.double() - want.double()).reshape(-1) != 0
    assert bool((x.abs()[diff] == kth).all())
    if kept:
        assert int((got.reshape(-1) != 0).sum()) <= k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,frac", [((128,), 0.1), ((4096,), 0.05),
                                        ((3, 64, 16), 0.05), ((7,), 0.05)])
def test_topk_matches_the_reference(dtype, shape, frac):
    x = _draw(shape, dtype, seed=1)
    rv, ri, rshape = RG.topk_compress(x, frac)
    pv, pi, pshape = topk_compress(_t(x), frac)
    assert tuple(rshape) == pshape and len(pv) == len(rv)
    assert _tname(pv) == str(rv.dtype) == dtype
    ry = RG.topk_decompress(rv, ri, rshape)
    py = topk_decompress(pv, pi, pshape)
    assert _tname(py) == str(ry.dtype) == dtype and py.shape == ry.shape
    _assert_topk_close(py, _t(ry), _t(x), len(rv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_error_feedback_matches_the_reference(dtype, mode):
    """Six steps over a tree with a stacked leaf (the reference's segment
    layout), which the port holds as three tensors compressed as one group.
    Each step of the port starts from the reference's residual: the sent
    gradients and the new residuals within the compressors' tolerances
    above (a tie broken otherwise, or a bf16 quotient rounded otherwise,
    would make two free runs part for good), their types exactly
    (``int8``'s turn float32 after one step).  In float32 the port's own
    run equals the reference's at every step."""
    rng = np.random.default_rng(3)
    shapes = {"b": (16,), "s": (3, 4, 40), "w": (8, 16)}

    def grads():
        return {k: jnp.asarray(rng.normal(size=s), jnp.dtype(dtype))
                for k, s in shapes.items()}

    def port_list(tree):
        return [_t(tree["b"])] + [_t(x) for x in tree["s"]] + [_t(tree["w"])]

    groups = [[0], [1, 2, 3], [4]]
    g = grads()
    rstate = ref_init_ef(g)
    own = init_error_feedback(port_list(g))
    for step in range(6):
        if step:
            g = grads()
        prev = port_list(rstate.residual)
        rsent, rstate = RG.compress_with_error_feedback(g, rstate, mode)
        psent, pstate = compress_with_error_feedback(
            port_list(g), ErrorFeedbackState(prev), mode, groups=groups)
        carried = [a + b for a, b in zip(port_list(g), prev)]
        for kept, got, want in (
                (True, psent, port_list(rsent)),
                (False, pstate.residual, port_list(rstate.residual))):
            assert [_tname(t) for t in got] == [_tname(t) for t in want]
            for group in groups:
                flat = [torch.cat([x[i].reshape(-1) for i in group])
                        for x in (got, want, carried)]
                if mode == "topk":
                    _assert_topk_close(*flat, max(1, int(
                        flat[2].numel() * 0.05)), kept)
                else:
                    scale = float(flat[2].double().abs().max()) / 127
                    _assert_int8_close(flat[0] / scale, flat[1] / scale,
                                       1.0, dtype)
        if dtype == "float32":
            own_sent, own = compress_with_error_feedback(
                port_list(g), own, mode, groups=groups)
            for got, want in ((own_sent, port_list(rsent)),
                              (own.residual, port_list(rstate.residual))):
                assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---- the reference's optimizer, compression and planner cases -------------

def test_adamw_converges():
    opt = AdamW(clip_norm=None)
    w = torch.tensor(5.0)
    state = opt.init([w])
    for _ in range(200):
        state = opt.update([2 * w], [w], state, 0.1)
    assert abs(float(w)) < 0.05


def test_int8_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)) * 3)
    q, s = int8_compress(x)
    y = int8_decompress(q, s)
    assert float((x - y).abs().max()) <= float(s) * 1.01


def test_topk_roundtrip():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(128,)))
    v, i, shp = topk_compress(x, frac=0.1)
    y = topk_decompress(v, i, shp)
    assert y.shape == x.shape
    # kept entries exact, others zero
    assert float((y[i] - x[i]).abs().max()) < 1e-6
    assert int((y != 0).sum()) == len(i)


def test_error_feedback_unbiased_over_time():
    """With error feedback, the cumulative transmitted signal approaches the
    cumulative true gradient."""
    rng = np.random.default_rng(2)
    g = [torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))]
    state = init_error_feedback(g)
    sent_total = torch.zeros(64)
    for _ in range(50):
        sent, state = compress_with_error_feedback(g, state, mode="int8")
        sent_total = sent_total + sent[0]
    want = g[0] * 50
    rel = float((sent_total - want).abs().max() / (want.abs().max() + 1e-9))
    assert rel < 0.05


def test_heartbeat_and_stragglers():
    hb = HeartbeatMonitor(timeout_s=10, straggler_factor=1.5)
    hb.beat(0, 1.0, now=100.0)
    hb.beat(1, 1.0, now=100.0)
    hb.beat(2, 5.0, now=100.0)
    assert hb.stragglers() == [2]
    assert hb.dead_hosts(now=105.0) == []
    assert set(hb.dead_hosts(now=150.0)) == {0, 1, 2}
    assert plan_backup_dispatch([2], [7]) == {2: 7}


def test_plan_remesh():
    # 128 hosts x 4 chips: prefers the most pods that keep model=16 intact
    got = plan_remesh(128, 4, 16)
    assert got is not None
    pod, data, model = got
    assert pod * data * model == 512 and model == 16
    # lose a host: 508 chips; any returned mesh must fit and keep model=16
    got = plan_remesh(127, 4, 16)
    if got is not None:
        pod, data, model = got
        assert pod * data * model <= 508


def test_planners_equal_the_reference_over_a_grid():
    for hosts in range(0, 40):
        for chips in (1, 2, 4, 8):
            for model in (1, 2, 3, 4, 8, 16):
                for pods in ((4, 2, 1), (2, 1), (8,), (3, 1)):
                    assert plan_remesh(hosts, chips, model, pods) == \
                        ref_ft.plan_remesh(hosts, chips, model, pods)
    for n in range(6):
        for m in range(6):
            stragglers, spares = list(range(n)), list(range(10, 10 + m))
            assert plan_backup_dispatch(stragglers, spares) == \
                ref_ft.plan_backup_dispatch(stragglers, spares)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_types_and_values_follow_the_reference(clip):
    """Three updates of a bf16 leaf, a float32 leaf and a second bf16 leaf
    against the reference's: every parameter and moment has the
    reference's type after each (bf16 parameters float32 from the first,
    bf16 moments from the second, or from the first where the clipping
    scale is float32), values within float32 rounding of the bf16 inputs."""
    rng = np.random.default_rng(4)
    shapes = {"a": ((5, 3), "bfloat16"), "b": ((4,), "float32"),
              "c": ((6,), "bfloat16")}
    rparams = {k: jnp.asarray(rng.normal(size=s), jnp.dtype(d))
               for k, (s, d) in shapes.items()}
    ropt = RefAdamW(weight_decay=0.1, clip_norm=clip)
    popt = AdamW(weight_decay=0.1, clip_norm=clip)
    rstate = ropt.init(rparams)
    pparams = [_t(rparams[k]) for k in sorted(shapes)]
    pstate = popt.init(pparams)
    for step in range(3):
        rgrads = {k: jnp.asarray(rng.normal(size=p.shape), p.dtype)
                  for k, p in rparams.items()}
        pgrads = [_t(rgrads[k]) for k in sorted(shapes)]
        lr = 1e-2 * (step + 1)
        rparams, rstate = ropt.update(rgrads, rparams, rstate,
                                      jnp.float32(lr))
        pstate = popt.update(pgrads, pparams, pstate, lr)
        assert pstate.step == int(rstate.step) == step + 1
        for tree, got in ((rparams, pparams), (rstate.mu, pstate.mu),
                          (rstate.nu, pstate.nu)):
            want = [_t(tree[k]) for k in sorted(shapes)]
            assert [_tname(t) for t in got] == [_tname(t) for t in want]
            for g, w in zip(got, want):
                assert torch.allclose(g.double(), w.double(), rtol=1e-5,
                                      atol=1e-7), (step, g, w)


# ---- make_train_step against the reference's step_fn ----------------------

def _configs(name, dtype):
    """The reference's and the port's reduced config of ``name``: float32
    as ``reduced()`` gives it, or bf16 with remat on (as the full-size
    configs are)."""
    kw = {} if dtype == "float32" else {"dtype": dtype, "remat": True}
    return (dataclasses.replace(ref_get_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


def _reference_params(rmodel):
    return jax.jit(RB.init_params, static_argnums=0)(
        rmodel, jax.random.PRNGKey(0))


def _as_port(pmodel, tree):
    """A reference tree laid out as the port's parameters: name -> tensor."""
    return dict(params_from_reference(
        pmodel, jax.tree.map(np.asarray, tree)).named_parameters())


def hold_train_steps(monkeypatch, name, mode, dtype, tol):
    """Run both steps side by side and hold them (see the docstring)."""
    loss_tol, upd_tol = tol
    rcfg, pcfg = _configs(name, dtype)
    rmodel, pmodel = RB.build_model(rcfg), PB.build_model(pcfg)
    rparams = _reference_params(rmodel)
    pparams = params_from_reference(pmodel, jax.tree.map(np.asarray,
                                                         rparams))
    names = [n for n, _ in pparams.named_parameters()]
    p0 = {n: p.detach().double().clone()
          for n, p in pparams.named_parameters()}
    ropt = RefAdamW(weight_decay=0.1, clip_norm=1.0)
    popt = AdamW(weight_decay=0.1, clip_norm=1.0)
    if mode == "topk":
        monkeypatch.setattr(ref_train, "train_loss",
                            jax.jit(RB.train_loss, static_argnums=0))
    rstep = ref_train.make_train_step(rmodel, ropt,
                                      ref_lr(LR, WARMUP, STEPS), mode)
    if mode != "topk":
        rstep = jax.jit(rstep)
    lr_fn = linear_warmup_cosine(LR, WARMUP, STEPS)
    pstep = port_train.make_train_step(pmodel, popt, lr_fn, mode)
    rstate, ref_ef = ropt.init(rparams), (ref_init_ef(rparams) if mode
                                          else None)
    plist = list(pparams.parameters())
    pstate = popt.init(plist)
    pef = init_error_feedback(plist) if mode else None
    pipe = TokenPipeline(vocab=rcfg.vocab, seq_len=S, batch_size=B)
    calls = []
    real = PL.flash_attention
    monkeypatch.setattr(PL, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    lr_sum = 0.0
    for step in range(STEPS):
        tokens = pipe.next_batch()["tokens"]
        rparams, rstate, ref_ef, rmet = rstep(
            rparams, rstate, ref_ef, {"tokens": jnp.asarray(tokens)},
            jnp.asarray(step, jnp.int32))
        pparams, pstate, pef, pmet = pstep(
            pparams, pstate, pef, {"tokens": torch.from_numpy(tokens).long()},
            step)
        lr_sum += lr_fn(step)
        assert sorted(pmet) == sorted(rmet) == ["aux", "loss", "nll"]
        rloss, ploss = float(rmet["loss"]), float(pmet["loss"])
        assert np.isfinite(ploss)
        assert abs(ploss - rloss) <= loss_tol * abs(rloss), (step, ploss,
                                                             rloss)
        # every leaf's type, exactly
        got = dict(pparams.named_parameters())
        want = _as_port(pmodel, rparams)
        leaves = [(got, want)]
        leaves.append((dict(zip(names, pstate.mu)),
                       _as_port(pmodel, rstate.mu)))
        leaves.append((dict(zip(names, pstate.nu)),
                       _as_port(pmodel, rstate.nu)))
        if mode:
            leaves.append((dict(zip(names, pef.residual)),
                           _as_port(pmodel, ref_ef.residual)))
        for g, w in leaves:
            assert {n: g[n].dtype for n in names} == \
                {n: w[n].dtype for n in names}, step
        # the parameters, in units of lr, and the update as a whole
        num = den = 0.0
        for n in names:
            d = got[n].detach().double() - want[n].detach().double()
            assert float(d.abs().max()) <= 2 * lr_sum + 1e-7, (step, n)
            num += float((d ** 2).sum())
            den += float(((want[n].detach().double() - p0[n]) ** 2).sum())
        assert num ** 0.5 <= upd_tol * den ** 0.5 + 1e-9, (step, num, den)
    assert not calls, "training called K4's wrapper"


# ---- remat ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_remat_changes_no_value_and_checkpoints_each_layer(monkeypatch,
                                                           name):
    """``remat=True`` against ``remat=False`` on the same parameters and
    batch: the same loss and the same gradients (the recompute repeats the
    forward's operations; limit 1e-6 of each gradient's largest entry, for
    sums the backward may order otherwise); each layer of every segment
    (the encoder's too) runs under non-reentrant ``checkpoint``; K4's
    wrapper is never called."""
    cfg = get_arch(name).reduced()
    calls, k4 = [], []
    real = PB.checkpoint

    def counted(fn, *a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *a, **kw)

    monkeypatch.setattr(PB, "checkpoint", counted)
    real_k4 = PL.flash_attention
    monkeypatch.setattr(PL, "flash_attention",
                        lambda *a, **k: k4.append(1) or real_k4(*a, **k))
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, 4, cfg.d_model))).float()
    out = {}
    for remat in (False, True):
        model = PB.build_model(dataclasses.replace(cfg, remat=remat))
        params = PB.init_params(model, torch.Generator().manual_seed(0))
        loss, aux = PB.train_loss(model, params, batch)
        loss.backward()
        out[remat] = (loss.item(), aux["aux"].item(),
                      {n: p.grad for n, p in params.named_parameters()})
    layers = sum(seg.count for seg in PB.all_segments(model))
    assert calls == [False] * layers
    assert not k4
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    assert out[True][1] == pytest.approx(out[False][1], rel=1e-6, abs=1e-9)
    for n, g in out[False][2].items():
        scale = float(g.abs().max())
        assert float((out[True][2][n] - g).abs().max()) <= 1e-6 * scale, n


def test_remat_is_off_outside_autograd(monkeypatch):
    """Prefill, decode and a forward under ``no_grad`` never checkpoint."""
    monkeypatch.setattr(PB, "checkpoint", lambda *a, **k: 1 / 0)
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(), remat=True)
    model = PB.build_model(cfg)
    params = PB.init_params(model, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 16)))
    with torch.no_grad():
        PB.train_loss(model, params, {"tokens": tokens})
    _, states = PB.prefill(model, params, {"tokens": tokens}, max_len=20)
    PB.decode(model, params, states, tokens[:, :1], 16)


def test_leaf_groups_are_the_reference_leaves():
    """``LMParams.leaf_groups`` stacks each segment's layers into the
    reference's leaves: the groups' stacked shapes are the leaves' shapes."""
    for name in ("llama3-8b", "recurrentgemma-9b", "seamless-m4t-medium"):
        cfg = ref_get_arch(name).reduced(n_layers=5)
        rmodel = RB.build_model(cfg)
        shapes = jax.eval_shape(lambda k: RB.init_params(rmodel, k),
                                jax.random.PRNGKey(0))
        want = sorted(tuple(x.shape) for x in jax.tree.leaves(shapes))
        pmodel = PB.build_model(get_arch(name).reduced(n_layers=5))
        params = PB.init_params(pmodel, torch.Generator().manual_seed(0))
        plist = list(params.parameters())
        names = [n for n, _ in params.named_parameters()]
        got = []
        for group in params.leaf_groups():
            shape = tuple(plist[group[0]].shape)
            if names[group[0]].startswith(("segments", "enc_segments")):
                shape = (len(group), *shape)
            got.append(shape)
        assert sorted(got) == want, name


# ---- the CLI against the reference's ---------------------------------------

_STEP_LINE = re.compile(r"^step +(\d+) loss=([-\d.]+) \((\d+) ms\)$")


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def _losses(lines):
    got = []
    for line in lines:
        m = _STEP_LINE.match(line)
        if m:
            got.append((int(m.group(1)), float(m.group(2))))
    return got


def _with_reference_weights(monkeypatch):
    """The port's CLI on the reference's ``init_params`` at PRNGKey(0)."""
    def init(model, generator, device=None):
        rmodel = RB.build_model(ref_get_arch(model.cfg.name.removesuffix(
            "-reduced")).reduced())
        return params_from_reference(
            model, jax.tree.map(np.asarray, _reference_params(rmodel)))

    monkeypatch.setattr(port_train, "init_params", init)


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-780m"])
def test_cli_prints_the_reference_losses(monkeypatch, name):
    """The same flags through both CLIs (the default lr, 3e-4, for 21
    steps) on a tied dense arch and an SSM: the same step lines, the losses equal to the printed precision
    (one unit of the fourth decimal).  At ten times that lr these reduced
    models amplify rounding about twofold a step, and the reference's own
    CLI and its plain jitted ``step_fn`` print losses 6e-3 apart by step
    10, so the CLI is held at its default."""
    argv = ["--arch", name, "--reduced", "--steps", "21", "--batch", "2",
            "--seq", "32"]
    want = _losses(_run(ref_train.main, argv))
    _with_reference_weights(monkeypatch)
    got = _losses(_run(port_train.main, argv + ["--device", "cpu"]))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 10, 20]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1.0001e-4, (got, want)


@pytest.mark.parametrize("name,key", [("internvl2-1b", "patches"),
                                      ("seamless-m4t-medium", "frames")])
def test_cli_vision_and_audio_archs_raise_as_the_reference(name, key):
    argv = ["--arch", name, "--reduced", "--steps", "1", "--batch", "1",
            "--seq", "16"]
    with pytest.raises(KeyError, match=key):
        ref_train.main(argv)
    with pytest.raises(KeyError, match=key):
        port_train.main(argv + ["--device", "cpu"])


def test_cli_without_a_card_exits_2(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port_train.main(["--arch", "smollm-135m", "--reduced"])
    assert e.value.code == 2
    with pytest.raises(RuntimeError):
        port_train.train("smollm-135m", reduced=True)


def test_resume_restores_the_parameters_and_the_pipeline_only(tmp_path):
    """A 53-step run checkpoints at step 50 (``checkpoint_every`` is 50, as
    in the reference).  ``--resume`` through the CLI prints the reference's
    lines and continues from step 50 with the uninterrupted run's loss
    there (the same parameters and batch); a resumed ``train`` gives that
    loss exactly, while its optimizer starts fresh (its step counts from 1
    again), so the next loss differs, as the reference's does."""
    ck = str(tmp_path / "ck")
    tc = port_train.TrainConfig(steps=53, checkpoint_dir=ck)
    first = port_train.train("smollm-135m", tc, batch=2, seq=32,
                             reduced=True, device="cpu")
    assert port_train.CheckpointManager(ck).all_steps() == [50]
    lines = _run(port_train.main, [
        "--arch", "smollm-135m", "--reduced", "--batch", "2", "--seq", "32",
        "--device", "cpu", "--checkpoint-dir", ck, "--steps", "53",
        "--resume"])
    assert lines[0] == "resumed from step 50"
    got = _losses(lines)
    assert [s for s, _ in got] == [50, 52]
    assert got[0][1] == float(f"{first.losses[50]:.4f}")
    steps = []
    resumed = port_train.train(
        "smollm-135m", tc, batch=2, seq=32, reduced=True, resume=True,
        device="cpu", callback=lambda step, p, opt, ef, met: steps.append(
            (step, opt.step)))
    assert resumed.start == 50 and steps == [(50, 1), (51, 2), (52, 3)]
    assert resumed.pipeline_state["step"] == 53
    assert resumed.losses[0] == first.losses[50]
    assert resumed.losses[1] != first.losses[51]


def test_reference_cli_resumes_the_same_way(tmp_path):
    """The reference's CLI with the same flags prints the same lines: the
    resume line, then steps 50 and 52."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", "smollm-135m", "--reduced", "--batch", "2", "--seq",
            "32", "--checkpoint-dir", ck, "--steps", "53"]
    whole = _run(ref_train.main, argv)
    lines = _run(ref_train.main, argv + ["--resume"])
    assert lines[0] == "resumed from step 50"
    assert lines[1].split(" (")[0] in [w.split(" (")[0] for w in whole]
    assert [s for s, _ in _losses(lines)] == [50, 52]
