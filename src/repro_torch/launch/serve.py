"""Serving launcher: a batched greedy decode loop with the paged KV store and
the learned offload prefetcher (the paper's technique as a framework
feature; see ``repro_torch.offload``).  Counterpart of the reference's
``repro.launch.serve``.

Positions handed to the store are *cache* positions (prefix-inflated for
VLM archs, the coordinate the KV cache is written at), so block and
HBM-capacity accounting agree with the cache layout.  The store's access
log can be dumped as a replay-core trace (``--dump-trace``) and replayed
like any serve scenario (``repro_torch.offload.serve_trace``).

The model runs eagerly on ``--device`` (``cuda`` by default, where every
attention block but the windowed one launches K4); with no card it exits
with an error unless ``--device cpu`` is given.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --requests 8 --prompt-len 64 --gen 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 8 --prompt-len 512 --gen 64       # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model, init_params
from repro_torch.models.builder import DTYPES, LMParams, decode, prefill
from repro_torch.offload.learned_prefetcher import OffloadPrefetcher
from repro_torch.offload.paged_store import BLOCK_TOKENS, PagedKVStore
from repro_torch.offload.serve_trace import (access_log_to_trace,
                                             save_trace_npz)


@dataclasses.dataclass
class ServeResult:
    """What one :func:`serve` run produced."""
    arch: str
    prefill_logits: torch.Tensor      # (B, 1, V), last prompt position
    decode_logits: torch.Tensor       # (gen - 1, B, V), one row per step
    tokens: np.ndarray                # (B, gen) greedy tokens
    stats: Dict[str, float]           # PagedKVStore.stats()
    access_log: List[Tuple[int, int]]
    step_ends: List[int]              # access-log length after each step
    blocks_per_seq: int
    prefill_s: float
    decode_s: float

    @property
    def n_decoded(self) -> int:
        """Tokens decoded in the timed loop: the first token of each
        request comes from prefill."""
        return self.tokens.shape[0] * (self.tokens.shape[1] - 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, reduced: bool = False, requests: int = 8,
          prompt_len: int = 64, gen: int = 32, hbm_blocks: int = 48,
          device: str = "cuda",
          params: Optional[LMParams] = None) -> ServeResult:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens for
    ``gen`` greedy tokens each.  ``params`` (on ``device``) replaces the
    random weights drawn from seed 0; the prompts are the reference's
    (numpy seed 0)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device; pass device='cpu' to "
                           "serve on the CPU")
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if params is None:
        params = init_params(
            model, torch.Generator(device=device).manual_seed(0))
    dtype = DTYPES[cfg.dtype]

    b, s = requests, prompt_len
    max_len = s + gen
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s))).to(device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(b, cfg.frontend_seq, cfg.d_model))).to(device, dtype)
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(b, max(s // 8, 8), cfg.d_model))).to(device, dtype)

    # VLM caches include the patch prefix: decode indices are cache-relative
    prefix = cfg.frontend_seq if cfg.family == "vlm" else 0
    max_len += prefix

    _sync(device)
    t0 = time.perf_counter()
    logits, states = prefill(model, params, batch, max_len=max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    # paged KV store + learned prefetcher drive host<->HBM block residency;
    # max_len is prefix-inflated, so the capacity accounting covers the
    # patch-prefix blocks a VLM decode sweeps through
    store = PagedKVStore(n_requests=b, max_len=max_len,
                         hbm_capacity_blocks=hbm_blocks)
    if store.blocks_per_seq * BLOCK_TOKENS < max_len:
        raise ValueError("store capacity accounting must cover the "
                         "prefix-inflated cache")
    pf = OffloadPrefetcher(store)

    prefill_logits = logits
    toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out_tokens = [toks]
    step_logits = []
    step_ends: List[int] = []
    t0 = time.perf_counter()
    for step in range(gen - 1):
        pos = prefix + s + step
        store.on_decode_step(pos)
        pf.step(pos)
        step_ends.append(len(store.access_log))
        logits, states = decode(model, params, states, toks, pos)
        step_logits.append(logits[:, -1])
        toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_tokens.append(toks)
    _sync(device)
    t_decode = time.perf_counter() - t0

    return ServeResult(
        arch=arch, prefill_logits=prefill_logits,
        decode_logits=(torch.stack(step_logits) if step_logits
                       else logits.new_zeros((0, b, cfg.vocab))),
        tokens=torch.cat(out_tokens, dim=1).cpu().numpy(),
        stats=store.stats(), access_log=list(store.access_log),
        step_ends=step_ends, blocks_per_seq=store.blocks_per_seq,
        prefill_s=t_prefill, decode_s=t_decode)


def dump_trace(result: ServeResult, path: str):
    """Write the run's KV-store access log as a replay-core trace (the
    ``repro_torch.offload.serve_trace`` npz layout); returns the trace."""
    trace = access_log_to_trace(
        result.access_log, n_requests=result.tokens.shape[0],
        blocks_per_seq=result.blocks_per_seq,
        name=f"serve-{result.arch}", step_ends=result.step_ends)
    save_trace_npz(trace, path)
    return trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--hbm-blocks", type=int, default=48,
                    help="HBM capacity of the paged KV store, in blocks")
    ap.add_argument("--dump-trace", default=None, metavar="PATH.npz",
                    help="write the KV store's access log as a replay-core "
                         "trace (repro_torch.offload.serve_trace npz layout)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda by default; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        ap.error("no CUDA device; pass --device cpu to serve on the CPU")

    res = serve(args.arch, reduced=args.reduced, requests=args.requests,
                prompt_len=args.prompt_len, gen=args.gen,
                hbm_blocks=args.hbm_blocks, device=args.device)
    b, st = args.requests, res.stats
    print(f"served {b} requests: prefill {res.prefill_s*1e3:.0f} ms, "
          f"{args.gen} tokens/request; {res.n_decoded} tokens decoded in "
          f"{res.decode_s*1e3:.0f} ms "
          f"({res.n_decoded/max(res.decode_s,1e-9):.0f} tok/s)")
    print(f"kv-store: hit-rate={st['hit_rate']:.3f} "
          f"prefetch-acc={st['prefetch_accuracy']:.3f} "
          f"host-bytes={st['host_bytes']/1e6:.1f}MB")
    print("sample tokens:", res.tokens[0, :16].tolist())

    if args.dump_trace:
        trace = dump_trace(res, args.dump_trace)
        print(f"dump-trace: {len(trace)} accesses over "
              f"{len(res.step_ends)} decode steps -> {args.dump_trace}")


if __name__ == "__main__":
    main()
