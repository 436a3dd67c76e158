"""The port's serve launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) at ``--reduced`` width on the CPU.

The reference's ``main`` runs as written, with its ``jax.jit`` made a
pass-through and its ``prefill``/``decode``/``PagedKVStore`` wrapped so
the test sees the prefill logits, every decode step's tokens and logits,
the store and the access-log length before each step.  The port's
``serve`` runs on the reference's weights (``init_params`` at
``PRNGKey(0)``, carried over by ``repro_torch.models.convert``).  Held
equal: the store's stats, its access log and step ends, and the dumped
npz's ``accesses`` byte for byte (and its meta).  Held within tolerance:
the prefill logits and every decode step's logits, teacher-forced on the
reference's tokens; and the greedy tokens are the reference's at every
step up to the first where the reference's top-2 gap is within that
tolerance (a near-tie may fork them).  The port's own ``main`` prints the
reference's store and dump lines.

Tolerance: float32, max |port - reference| <= 1e-4 x max |reference|
per logits array.
"""
import contextlib
import io
import types

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
from repro.configs import get_arch as ref_get_arch
from repro.models import builder as RB
from repro_torch.configs import get_arch
from repro_torch.launch import serve as port_serve
from repro_torch.models import builder as PB
from repro_torch.models.convert import params_from_reference
from repro_torch.offload.serve_trace import load_trace_npz, trace_step_bounds

RTOL = 1e-4
#: a dense arch and a VLM (prefix-inflated cache positions): (arch,
#: requests, prompt length, generated tokens, HBM blocks)
CASES = (("llama3-8b", 4, 64, 8, 6), ("internvl2-1b", 3, 60, 6, 4))


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), err


def _argv(arch, requests, prompt, gen, hbm, path):
    return ["--arch", arch, "--reduced", "--requests", str(requests),
            "--prompt-len", str(prompt), "--gen", str(gen), "--hbm-blocks",
            str(hbm), "--dump-trace", str(path)]


def _reference_run(monkeypatch, argv):
    """The reference's ``main`` on ``argv``: (stdout, record)."""
    rec = {"decode": [], "stores": []}

    class Store(ref_serve.PagedKVStore):
        def __post_init__(self):
            super().__post_init__()
            rec["stores"].append(self)

    def prefill(model, params, batch, max_len=None):
        out = RB.prefill(model, params, batch, max_len=max_len)
        rec["prefill"] = np.asarray(out[0])
        return out

    def decode(model, params, states, toks, index):
        out = RB.decode(model, params, states, toks, index)
        rec["decode"].append((np.array(toks)[:, 0], int(index),
                              len(rec["stores"][0].access_log),
                              np.asarray(out[0])[:, -1]))
        return out

    monkeypatch.setattr(ref_serve, "PagedKVStore", Store)
    monkeypatch.setattr(ref_serve, "prefill", prefill)
    monkeypatch.setattr(ref_serve, "decode", decode)
    monkeypatch.setattr(ref_serve, "jax", types.SimpleNamespace(
        jit=lambda f: f, random=jax.random,
        block_until_ready=jax.block_until_ready))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_serve.main(argv)
    return out.getvalue(), rec


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def runs(request, tmp_path_factory):
    arch, requests, prompt, gen, hbm = request.param
    tmp = tmp_path_factory.mktemp(arch)
    with pytest.MonkeyPatch.context() as mp:
        stdout, rec = _reference_run(
            mp, _argv(arch, requests, prompt, gen, hbm, tmp / "ref.npz"))
    rmodel = RB.build_model(ref_get_arch(arch).reduced())
    tree = jax.tree.map(np.asarray,
                        RB.init_params(rmodel, jax.random.PRNGKey(0)))
    pmodel = PB.build_model(get_arch(arch).reduced())
    params = params_from_reference(pmodel, tree)
    res = port_serve.serve(arch, reduced=True, requests=requests,
                           prompt_len=prompt, gen=gen, hbm_blocks=hbm,
                           device="cpu", params=params)
    port_serve.dump_trace(res, str(tmp / "port.npz"))
    return types.SimpleNamespace(
        arch=arch, argv=_argv(arch, requests, prompt, gen, hbm,
                              tmp / "main.npz"),
        stdout=stdout, rec=rec, res=res, model=pmodel, params=params,
        tmp=tmp, prompt=prompt, gen=gen)


def test_store_stats_and_access_log_equal_the_reference(runs):
    store = runs.rec["stores"][0]
    assert runs.res.stats == store.stats()
    assert runs.res.access_log == store.access_log
    assert runs.res.step_ends == [ends for _, _, ends, _ in runs.rec["decode"]]
    assert len(runs.res.step_ends) == runs.gen - 1
    assert store.evictions > 0          # the store really evicts


def test_dumped_trace_equals_the_reference(runs):
    with np.load(runs.tmp / "ref.npz") as want, \
            np.load(runs.tmp / "port.npz") as got:
        assert got["accesses"].dtype == want["accesses"].dtype
        assert got["accesses"].tobytes() == want["accesses"].tobytes()
        assert str(got["meta"]) == str(want["meta"])
    trace = load_trace_npz(str(runs.tmp / "port.npz"))
    assert list(trace_step_bounds(trace)) == runs.res.step_ends


def test_logits_match_the_reference_teacher_forced(runs):
    """Prefill logits, then every decode step fed the reference's token
    at the reference's index."""
    close(runs.res.prefill_logits.numpy(), runs.rec["prefill"])
    cfg = get_arch(runs.arch).reduced()
    prefix = cfg.frontend_seq if cfg.family == "vlm" else 0
    b, s = runs.res.tokens.shape[0], runs.prompt
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(b, cfg.frontend_seq, cfg.d_model))).float()
    _, states = PB.prefill(runs.model, runs.params, batch,
                           max_len=prefix + s + runs.gen)
    for toks, index, _, want in runs.rec["decode"]:
        logits, states = PB.decode(runs.model, runs.params, states,
                                   torch.from_numpy(toks).long()[:, None],
                                   index)
        close(logits[:, -1].numpy(), want)


def test_greedy_tokens_follow_the_reference(runs):
    steps = [runs.rec["prefill"][:, -1]] + [
        want for _, _, _, want in runs.rec["decode"]]
    want_tokens = np.stack([np.argmax(x, -1) for x in steps], axis=1)
    assert runs.res.tokens.shape == want_tokens.shape
    compared = 0
    for r in range(want_tokens.shape[0]):
        for t, logits in enumerate(steps):
            top2 = np.sort(logits[r])[-2:]
            if top2[1] - top2[0] <= RTOL * np.abs(logits).max():
                break           # a near-tie: the runs may fork here
            assert runs.res.tokens[r, t] == want_tokens[r, t], (r, t)
            compared += 1
    assert compared >= want_tokens.size // 2


def test_port_main_prints_the_references_store_lines(runs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_serve.main(runs.argv + ["--device", "cpu"])
    want = [ln for ln in runs.stdout.splitlines()
            if ln.startswith(("kv-store:", "dump-trace:"))]
    got = [ln for ln in out.getvalue().splitlines()
           if ln.startswith(("kv-store:", "dump-trace:"))]
    assert len(want) == 2 and got == [w.replace("ref.npz", "main.npz")
                                      for w in want]
    with np.load(runs.tmp / "ref.npz") as a, \
            np.load(runs.tmp / "main.npz") as b:
        assert a["accesses"].tobytes() == b["accesses"].tobytes()


def test_no_card_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        port_serve.main(["--arch", "llama3-8b", "--reduced"])
    assert exc.value.code != 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.serve("llama3-8b", reduced=True)
