"""Autoregressive-decode microbenchmarks (the decode leg of the serve
suite).

Closed-loop token throughput through the iteration-level scheduler
(:class:`~tosem_tpu_torch.serve.batching.DecodeQueue` over
:class:`~tosem_tpu_torch.serve.backends.BertDecodeBackend`) against the
naive baseline the paged cache replaces: re-encoding the WHOLE prefix
through the causal prefill for every generated token (O(T²) per
sequence, no KV reuse). Both arms serve the same causal decoder with the
same seed, so their greedy token paths are identical — the A/B isolates
exactly what continuous batching + the paged cache buy.

Four scenario legs cover the decode fast paths on top of that:

- ``window`` — sliding-window paged decode at t8192 against the
  full-cache step, with the live-page bound asserted (constant-memory
  long-context decode). The full arm's step is
  :meth:`~tosem_tpu_torch.models.bert.Bert.decode_step_fn` (B4 over
  every page), the window arm's
  :meth:`~tosem_tpu_torch.models.bert.Bert.decode_multi_fn` with
  ``window=`` and ``page_offsets`` over its narrow rolling table (B5).
- ``spec`` — speculative decoding (draft k=4 via prompt-lookup) against
  single-token decode, accepted-tokens/s with the two arms' greedy
  outputs pinned identical.
- ``beam`` — n=4 beam fanout through COW page sharing, with the
  group-vs-single page-allocation ratio asserted <= 1.5x at equal
  prefix.
- ``prefix`` — radix prefix cache on vs off at 0.75 prefix share:
  admit-to-first-token (``max_new_tokens=1``) warm vs cold with the
  greedy outputs pinned identical, plus a multi-turn session leg proving
  suffix-only prefill via the prefill-token counters (zero per-admit
  cache misses).

Interleaved A/B rounds per the bench-noise protocol (both arms of a
round share the host phase; the speedup ratio is phase-immune). After
warmup the decode arm must never build a new step callable — one step
per (page config, max-batch) — which the bench ASSERTS via the replica's
compile-cache miss count before/after the timed rounds. The paged c16
leg additionally reports per-token p50/p99 latency rows next to its
throughput.

A copy of the JAX package's ``serve/bench_decode.py``. What differs:

- Every answer check raises as in the reference (paged ≡ re-encode,
  spec ≡ single, the window's page bound and evictions, the beam
  group's page ratio, prefix warm ≡ cold, the session's suffix-only
  prefill, no cache miss after warm-up). The reference's SPEED floors
  (window ≥ 2x the full cache, speculative ≥ 1.5x single-token,
  prefix-hit TTFT ≥ 2x cold) were set on a TPU; no speed target carries
  over to the port (ROADMAP.md's ground rules), so each ratio row
  carries the reference's floor and ``floor_met`` in ``extra`` and the
  bench does not raise on it.
- The legs take the model ``preset`` through (default the reference's
  tiny decoder) and run their backends on ``device`` (the card unless
  the caller asks for the CPU); the module's workload constants are the
  reference's.
- ``backends`` may replace the two deployed classes (a caller that
  reads what happens inside the replicas), and ``replica_stats``, a
  list, receives every deployed replica's ``stats()`` just before its
  deployment is deleted.
- The reference's ``--save``/``--check`` baseline gate is not ported.

``python -m tosem_tpu_torch.cli --config=decode_bench`` runs it
(``--config=decode_scenarios`` the four scenario legs only).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from tosem_tpu_torch.serve.backends import CompiledBackendMixin
from tosem_tpu_torch.serve.bench_common import (SuiteEmitter, closed_loop,
                                                per_unit_percentiles)
from tosem_tpu_torch.utils.results import ResultRow

# the JAX package's perf-gated rows of this suite (its ci.sh --perf)
GATED_DECODE_BENCHES = (
    "decode_paged_c1", "decode_paged_c16", "decode_speedup_c16",
    "decode_paged_c16_p50_ms", "decode_paged_c16_p99_ms",
    "decode_window_t8192", "decode_window_speedup_t8192",
    "decode_spec_c8", "decode_spec_speedup_c8",
    "decode_beam_c4",
    "decode_prefix_warm_ttft_ms", "decode_prefix_ttft_speedup",
)

# --config=decode_scenarios legs
SCENARIO_BENCHES = {
    "window": ("decode_full_t8192", "decode_window_t8192",
               "decode_window_speedup_t8192"),
    "spec": ("decode_single_c8", "decode_spec_c8",
             "decode_spec_speedup_c8"),
    "beam": ("decode_beam_c4", "decode_beam_pages_ratio"),
    "prefix": ("decode_prefix_cold_ttft_ms", "decode_prefix_warm_ttft_ms",
               "decode_prefix_ttft_speedup",
               "decode_prefix_session_suffix_frac"),
}

# the reference's speed floors, reported beside each ratio, never raised
SPEED_FLOORS = {"decode_window_speedup_t8192": 2.0,
                "decode_spec_speedup_c8": 1.5,
                "decode_prefix_ttft_speedup": 2.0}

# One model config for both arms (and the parity pin): tiny topology,
# page-multiple max_len, enough pages for 16 sequences of
# prompt+generated <= 3 pages each. 32 generated tokens per prompt is
# where the paged-vs-re-encode physics shows: the baseline's per-token
# cost GROWS with the prefix (O(T^2) per sequence) while the paged
# arm's stays one step's share.
MODEL_KW = dict(max_batch=16, max_len=128, page_size=16, num_pages=96,
                max_new_tokens=32)
PROMPT_LEN = 12

# spec/beam scenario config: longer generations so draft acceptance and
# COW divergence have room to act, 8 concurrent sequences
SCEN_KW = dict(max_batch=8, max_len=192, page_size=16, num_pages=128,
               max_new_tokens=48)

# prefix scenario: 256-token prompts sharing a 192-token hot prefix
# (0.75 share, 12 whole pages); the suffix rides ONE wide multi-query
# chunk (suffix_q=64), so a warm admit pays one call where a cold admit
# pays the full 256-token prefill
PREFIX_PLEN = 256
PREFIX_SHARE = 192
PREFIX_KW = dict(max_batch=8, max_len=288, page_size=16, num_pages=64,
                 max_new_tokens=48)

# window scenario: t8192 context, w1024 sliding window, 128-token pages
WIN_T = 8192
WIN_W = 1024
WIN_PAGE = 128
WIN_B = 4


def _prompt(i: int) -> Dict[str, Any]:
    return {"ids": [1 + ((i * 7 + j) % 126) for j in range(PROMPT_LEN)]}


def _config(preset: str, **overrides):
    """The decoder every arm serves: the backends' tiny topology, or
    BERT-base's widths for ``preset="base"``."""
    import dataclasses

    from tosem_tpu_torch.models.bert import BertConfig
    if preset == "base":
        return dataclasses.replace(BertConfig.base(), **overrides)
    kw = dict(vocab_size=128, max_len=128, dim=32, heads=2, layers=2,
              mlp_dim=64, dropout=0.0)
    kw.update(overrides)
    return BertConfig(**kw)


class NaiveRecodeBackend(CompiledBackendMixin):
    """The no-KV-cache baseline: every generated token re-runs the
    causal prefill over the whole prefix (padded to the page-multiple
    bucket palette), argmaxes the last row, appends, repeats. Same
    model, seed, and greedy rule as :class:`BertDecodeBackend`, so both
    arms emit the same tokens — this arm just recomputes every cached
    K/V from scratch each step. ``params`` is a JAX-package parameter
    tree to load instead of the seed's random init, as the decode
    backend takes it."""

    def __init__(self, preset: str = "tiny", seed: int = 0,
                 max_len: int = 128, page_size: int = 16,
                 max_new_tokens: int = 16, device="cuda", params=None):
        from tosem_tpu_torch.serve.backends import _build_model, model_tag
        from tosem_tpu_torch.serve.compile_cache import CompileCache
        cfg = (_config("base") if preset == "base"
               else _config("tiny", max_len=max_len))
        self.cfg = cfg
        self.page = page_size
        self.max_new_tokens = max_new_tokens
        self.model = _build_model(cfg, device, seed, params)
        self.device = self.model.device
        self._prefill = self.model.prefill_fn()
        self._tag = model_tag("bert_recode", cfg, seed)
        self._steps = CompileCache()
        self._lock = threading.Lock()

    def _compiled(self, pad_to: int):
        from tosem_tpu_torch.serve.compile_cache import shape_key
        key = shape_key(self._tag, (1, pad_to), self.cfg.dtype)
        return self._steps.get_or_build(key, lambda: self._prefill)

    def call(self, request: Dict[str, Any]) -> Any:
        import numpy as np
        import torch
        toks = list(request["ids"])
        prompt_len = len(toks)
        with self._lock:
            for _ in range(self.max_new_tokens):
                T = len(toks)
                if T >= self.cfg.max_len:
                    break
                bucket = -(-T // self.page) * self.page
                ids = np.zeros((1, bucket), np.int32)
                mask = np.zeros((1, bucket), np.int32)
                ids[0, :T] = toks
                mask[0, :T] = 1
                logits, _, _ = self._compiled(bucket)(
                    torch.as_tensor(ids, device=self.device),
                    torch.as_tensor(mask, device=self.device))
                row = logits[0, T - 1].float().cpu().numpy()
                toks.append(int(np.argmax(row)))
        return {"tokens": toks, "generated": toks[prompt_len:],
                "prompt_len": prompt_len}


def _token_loop(handle, n_clients: int, min_s: float,
                samples: Optional[list] = None,
                count_of=None) -> float:
    """``n_clients`` threads, each submitting prompts closed-loop for
    >= ``min_s`` → generated tokens/s across the fleet (the shared fleet
    of :mod:`tosem_tpu_torch.serve.bench_common`; ``samples`` collects
    (latency, tokens) pairs for the per-token percentile rows)."""
    return closed_loop(handle.call, n_clients, min_s,
                       lambda i, k: _prompt(i + k * n_clients),
                       count_of=count_of or
                       (lambda out: len(out["generated"])),
                       timeout=300.0, samples=samples)


def _retire(serve, name: str, sink: Optional[list]) -> None:
    """Delete a deployment, first handing each replica's ``stats()`` to
    ``sink`` (when given)."""
    if sink is not None:
        import tosem_tpu_torch.runtime as rt
        dep = serve.get_deployment(name)
        for r in list(dep._replicas):
            st = rt.get(r.stats.remote(), timeout=60.0)
            sink.append(dict(st, deployment=name))
    serve.delete(name)


# ---------------------------------------------------------------------------
# scenario legs


def _window_leg(em: SuiteEmitter, trials: int, min_s: float, preset: str,
                device) -> None:
    """Sliding-window vs full-cache decode at t8192, step level: both
    arms run the SAME causal decoder (fp32) over a synthetic 8191-token
    history (allocator state is real — the window arm's cache was grown
    page by page with ``release_below`` applied, exactly the serving
    discipline), and each round times N fixed-state step calls per arm
    on the host clock, synchronized at the end. The full arm reads all
    64 pages per token; the window arm's rolling table holds
    ceil(w/page)+2 pages, asserted, which is the constant-memory claim.
    The speedup is reported beside the reference's 2x floor."""
    import numpy as np
    import torch

    from tosem_tpu_torch.ops.common import resolve_device
    from tosem_tpu_torch.serve.backends import _build_model
    from tosem_tpu_torch.serve.kv_cache import PagedKVCache

    dev = resolve_device(device)
    T, W, PAGE, B = WIN_T, WIN_W, WIN_PAGE, WIN_B
    bound = -(-W // PAGE) + 2
    cfg = _config(preset, max_len=T, dtype="float32")
    model = _build_model(cfg, dev, 0, None)
    L, H, Dh = cfg.layers, cfg.heads, cfg.dim // cfg.heads
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_full = T // PAGE

    def filled(cache):
        shape = tuple(cache.k_pool.shape)
        cache.set_pools(
            torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))
        return cache

    # FULL arm: every page of the 8191-token history stays live
    full = PagedKVCache(B * n_full + 1, PAGE, layers=L, heads=H,
                        head_dim=Dh, dtype="float32", device=dev)
    for b in range(B):
        full.create(f"s{b}")
        full.extend(f"s{b}", T - 1)
    filled(full)
    step_full = model.decode_step_fn(page_size=PAGE)
    tables_f = torch.as_tensor(np.stack(
        [full.block_table(f"s{b}", n_full) for b in range(B)]), device=dev)

    # WINDOW arm: grown page by page with eviction riding along, so the
    # pool never holds more than the rolling window (bounded memory)
    win = PagedKVCache(B * bound + 8, PAGE, layers=L, heads=H,
                       head_dim=Dh, dtype="float32", device=dev)
    for b in range(B):
        cid = f"w{b}"
        win.create(cid)
        grown = 0
        while grown < T - 1:
            n = min(PAGE, T - 1 - grown)
            win.extend(cid, n)
            grown += n
            win.release_below(cid, grown + 1 - W)
        live = len(win.pages_of(cid))
        if live > bound:
            raise RuntimeError(
                f"window arm holds {live} live pages > "
                f"ceil(window/page)+2 = {bound} — eviction broke")
    filled(win)
    if win.stats()["pages_evicted_total"] <= 0:
        raise RuntimeError("window arm never evicted a page")
    table_w = bound + 2
    step_win = model.decode_multi_fn(page_size=PAGE, q_tokens=1, window=W)
    tables_w = torch.as_tensor(np.stack(
        [win.block_table(f"w{b}", table_w) for b in range(B)]), device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    offs = torch.as_tensor([win.page_offset(f"w{b}") for b in range(B)],
                           **i32)

    ids1 = torch.as_tensor(rng.integers(1, 127, B), **i32)
    pos1 = torch.full((B,), T - 1, **i32)
    lens = torch.full((B,), T, **i32)
    idsK = ids1[:, None]
    posK = pos1[:, None]
    ones = torch.ones((B,), **i32)

    def run_full():
        return step_full(ids1, pos1, full.k_pool, full.v_pool, tables_f,
                         lens)

    def run_win():
        return step_win(idsK, posK, win.k_pool, win.v_pool, tables_w,
                        lens, ones, offs)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, n_calls):
        sync()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        sync()
        return time.perf_counter() - t0

    run_full()                 # kernel builds and first calls off the clock
    run_win()
    dt = timed(run_full, 2) / 2
    n_calls = max(3, int(min_s / max(dt, 1e-4)))
    f_rates, w_rates, speedups = [], [], []
    for _ in range(max(trials, 1)):
        tf = timed(run_full, n_calls)
        tw = timed(run_win, n_calls)
        f_rates.append(n_calls * B / tf)
        w_rates.append(n_calls * B / tw)
        speedups.append(tf / tw)
    em.emit("decode_full_t8192", "decode full-cache t8192 b4",
            f_rates, unit="tokens/s")
    row = em.emit("decode_window_t8192",
                  f"decode window w{W} t8192 b4", w_rates,
                  unit="tokens/s")
    if row is not None:
        row.extra["live_pages_per_seq"] = len(win.pages_of("w0"))
        row.extra["live_pages_bound"] = bound
        row.extra["pages_evicted"] = win.stats()["pages_evicted_total"]
        row.extra["calls_per_round"] = n_calls
    em.emit_floored("decode_window_speedup_t8192",
                    "decode window vs full-cache speedup t8192", speedups,
                    SPEED_FLOORS["decode_window_speedup_t8192"])


def _spec_leg(em: SuiteEmitter, serve, trials: int, min_s: float,
              kw: Dict[str, Any], decode_cls, sink) -> None:
    """Speculative (draft k=4, prompt-lookup drafter) vs single-token
    decode through the serve data plane, 8 concurrent sequences. Pins
    the two arms' greedy outputs identical (the accept-prefix + rollback
    construction); the accepted-tokens/s ratio is reported beside the
    reference's 1.5x floor."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.serve.batching import DecodePolicy

    serve.deploy("bench-spec", decode_cls, num_replicas=1, max_retries=1,
                 init_kwargs=dict(SCEN_KW, spec_k=4, **kw),
                 decode_policy=DecodePolicy(max_active=8),
                 warmup_shapes=[16])
    serve.deploy("bench-single", decode_cls, num_replicas=1,
                 max_retries=1, init_kwargs=dict(SCEN_KW, **kw),
                 decode_policy=DecodePolicy(max_active=8),
                 warmup_shapes=[16])
    h_spec = serve.get_handle("bench-spec")
    h_single = serve.get_handle("bench-single")
    for i in range(3):                       # parity pin, several chains
        a = h_spec.call(_prompt(i), timeout=300.0)
        b = h_single.call(_prompt(i), timeout=300.0)
        if a["tokens"] != b["tokens"]:
            raise RuntimeError(
                f"speculative and single-token arms diverged on prompt "
                f"{i}: {a['tokens']} vs {b['tokens']}")
    single, spec, speedups = [], [], []
    for _ in range(max(trials, 1)):
        a = _token_loop(h_single, 8, min_s)
        b = _token_loop(h_spec, 8, min_s)
        single.append(a)
        spec.append(b)
        speedups.append(b / a if a else float("inf"))
    em.emit("decode_single_c8", "decode single-token c8", single,
            unit="tokens/s")
    row = em.emit("decode_spec_c8", "decode speculative k4 c8", spec,
                  unit="tokens/s")
    if row is not None:
        st = rt.get(serve.get_deployment("bench-spec")
                    ._replicas[0].cache_stats.remote(), timeout=60.0)
        if st.get("spec_proposed"):
            row.extra["acceptance_rate"] = round(
                st["spec_accepted"] / st["spec_proposed"], 3)
    em.emit_floored("decode_spec_speedup_c8",
                    "decode speculative vs single-token speedup c8",
                    speedups, SPEED_FLOORS["decode_spec_speedup_c8"])
    _retire(serve, "bench-spec", sink)
    _retire(serve, "bench-single", sink)


def _beam_leg(em: SuiteEmitter, serve, trials: int, min_s: float,
              kw: Dict[str, Any], decode_cls, sink) -> None:
    """n=4 beam fanout through the serve data plane (tokens/s counts
    every branch's committed tokens), plus the COW page-sharing proof:
    a 4-branch group at equal prefix length must allocate <= 1.5x the
    pages of a single sequence (hard assert + lower-is-better row)."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy, SamplingPolicy

    # page-sharing proof on a raw backend: multi-page prefix, measured
    # immediately after admit (prefix shared, branches not yet diverged)
    probe = BertDecodeBackend(**SCEN_KW, **kw)
    long_prompt = {"ids": [1 + (j % 126) for j in range(48)]}
    probe.admit("single", dict(long_prompt))
    single_pages = probe.cache.stats()["pages_used"]
    probe.admit("group", {**long_prompt, "n": 4, "beam": True})
    group_pages = probe.cache.stats()["pages_used"] - single_pages
    ratio = group_pages / max(single_pages, 1)
    if ratio > 1.5:
        raise RuntimeError(
            f"beam n=4 allocated {group_pages} pages vs single "
            f"{single_pages} ({ratio:.2f}x > 1.5x) — COW sharing broke")
    probe.release("single")
    probe.release("group")
    del probe
    em.emit("decode_beam_pages_ratio",
            "beam n4 vs single page-allocation ratio", [ratio],
            unit="x", lower_is_better=True)

    serve.deploy("bench-beam", decode_cls, num_replicas=1, max_retries=1,
                 init_kwargs=dict(SCEN_KW, **kw),
                 decode_policy=DecodePolicy(
                     max_active=8,
                     sampling=SamplingPolicy(n=4, beam=True)),
                 warmup_shapes=[16])
    h = serve.get_handle("bench-beam")
    out = h.call(_prompt(0), timeout=300.0)
    if len(out["beams"]) != 4:
        raise RuntimeError(f"expected 4 beams, got {len(out['beams'])}")

    def count(out):
        return sum(len(e["generated"]) for e in out["beams"])
    rates = []
    for _ in range(max(trials, 1)):
        rates.append(_token_loop(h, 2, min_s, count_of=count))
    em.emit("decode_beam_c4", "decode beam n4 c2 all-branch tokens",
            rates, unit="tokens/s")
    _retire(serve, "bench-beam", sink)


def _prefix_leg(em: SuiteEmitter, serve, trials: int, min_s: float,
                kw: Dict[str, Any], decode_cls, sink) -> None:
    """Prefix-cache A/B at 0.75 prefix share: admit-to-first-token
    (per-request ``max_new_tokens=1`` — the sequence finishes AT admit,
    so admit latency IS TTFT) with the radix cache on vs off.
    Interleaved rounds; the two arms' greedy outputs are pinned
    identical first, the warm arm must record prefix hits and build no
    step callable in the timed rounds, and its TTFT advantage is
    reported beside the reference's 2x floor. A multi-turn session leg
    then proves suffix-only prefill via the backend's prefill-token
    counters (with zero per-admit cache misses)."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy

    shared = [1 + ((7 * j) % 126) for j in range(PREFIX_SHARE)]

    def prefix_prompt(i: int) -> Dict[str, Any]:
        return {"ids": shared + [1 + ((i * 11 + j) % 126)
                                 for j in range(PREFIX_PLEN
                                                - PREFIX_SHARE)]}

    # TTFT A/B on raw in-process backends (the beam leg's probe idiom):
    # admit latency IS the quantity under test, so the arms must not
    # hide behind the data plane's per-call overhead
    warm = BertDecodeBackend(**PREFIX_KW, **kw)
    cold = BertDecodeBackend(prefix_cache=False, **PREFIX_KW, **kw)

    # parity pin (and warm-arm seeding): prompt 0 populates the radix
    # index, prompts 1..3 take the suffix-prefill hit path — their
    # greedy streams must match the cold arm's
    for i in range(4):
        a = warm.call(dict(prefix_prompt(i), max_new_tokens=8))
        b = cold.call(dict(prefix_prompt(i), max_new_tokens=8))
        if a["tokens"] != b["tokens"]:
            raise RuntimeError(
                f"prefix-hit and cold-prefill arms diverged on prompt "
                f"{i}: {a['tokens']} vs {b['tokens']}")

    def ttft_ms(backend, n: int, base: int) -> float:
        total = 0.0
        for i in range(n):
            req = dict(prefix_prompt(base + i), max_new_tokens=1)
            t0 = time.perf_counter()
            backend.admit(f"ttft/{base + i}", req)
            total += time.perf_counter() - t0
            backend.release(f"ttft/{base + i}")
        return total * 1000.0 / n

    def misses():
        return (warm.stats()["compile_cache"]["misses"]
                + cold.stats()["compile_cache"]["misses"])

    misses_before = misses()
    cold_ms, warm_ms, speedups = [], [], []
    per_round = 12
    for r in range(max(trials, 1)):
        # one A/B round, both arms in the same host phase; fresh
        # suffixes per round so the COLD arm never amortizes anything
        base = 4 + r * per_round
        a = ttft_ms(cold, per_round, base)
        b = ttft_ms(warm, per_round, base)
        cold_ms.append(a)
        warm_ms.append(b)
        speedups.append(a / b if b else float("inf"))
    st = warm.cache_stats()
    if not st.get("prefix_hits"):
        raise RuntimeError(
            "warm arm recorded zero prefix hits — the radix index "
            "never engaged and the A/B measured nothing")
    if misses() != misses_before:
        raise RuntimeError(
            "prefix A/B built a step callable during the timed rounds "
            f"({misses() - misses_before} new compile-cache misses)")
    del warm, cold

    em.emit("decode_prefix_cold_ttft_ms",
            "decode cold-prefill TTFT share0.75", cold_ms,
            unit="ms", lower_is_better=True)
    row = em.emit("decode_prefix_warm_ttft_ms",
                  "decode prefix-hit TTFT share0.75", warm_ms,
                  unit="ms", lower_is_better=True)
    if row is not None:
        hits = st["prefix_hits"]
        row.extra["prefix_hit_rate"] = round(
            hits / max(hits + st["prefix_misses"], 1), 3)
        row.extra["pages_reused"] = st["prefix_pages_reused"]
        row.extra["pages_prefilled"] = st["prefix_pages_prefilled"]
    em.emit_floored("decode_prefix_ttft_speedup",
                    "decode prefix-hit vs cold-prefill TTFT speedup "
                    "share0.75", speedups,
                    SPEED_FLOORS["decode_prefix_ttft_speedup"])

    # multi-turn session leg: turn 2 replays turn 1's history + 2 new
    # tokens; the backend must prefill ONLY the suffix (history KV
    # stays resident under the session key) — asserted exactly via the
    # prefill-token counter delta, with zero cache misses
    serve.deploy("bench-prefix-sess", decode_cls, num_replicas=1,
                 max_retries=1, init_kwargs=dict(PREFIX_KW, **kw),
                 decode_policy=DecodePolicy(max_active=8, session=True),
                 warmup_shapes=[16])
    h = serve.get_handle("bench-prefix-sess")
    dep = serve.get_deployment("bench-prefix-sess")

    def sess_stats():
        return rt.get(dep._replicas[0].stats.remote(), timeout=60.0)

    fracs = []
    for r in range(max(trials, 1)):
        turn1 = {"ids": prefix_prompt(100 + r)["ids"],
                 "session": f"bench/{r}", "max_new_tokens": 8}
        hist = h.call(turn1, timeout=300.0)["tokens"]
        ids2 = hist + [9, 9]
        before = sess_stats()
        out2 = h.call({"ids": ids2, "session": f"bench/{r}",
                       "max_new_tokens": 8}, timeout=300.0)
        after = sess_stats()
        prefilled = after["prefill_tokens"] - before["prefill_tokens"]
        # session resume holds len(hist)-1 positions; the admit feeds
        # exactly the suffix (history's last token + the 2 new ones)
        want_suffix = len(ids2) - (len(hist) - 1)
        if prefilled != want_suffix:
            raise RuntimeError(
                f"session turn 2 prefilled {prefilled} tokens, "
                f"expected the {want_suffix}-token suffix only")
        if after["compile_cache"]["misses"] != \
                before["compile_cache"]["misses"]:
            raise RuntimeError("session resume built a step at admit")
        if out2["tokens"][:len(ids2)] != ids2:
            raise RuntimeError("session turn 2 lost its history")
        fracs.append(prefilled / len(ids2))
    em.emit("decode_prefix_session_suffix_frac",
            "decode session turn-2 prefilled-token fraction", fracs,
            unit="frac", lower_is_better=True)
    _retire(serve, "bench-prefix-sess", sink)


def run_decode_benchmarks(trials: int = 3, min_s: float = 0.5,
                          quiet: bool = False,
                          only: Optional[set] = None, *,
                          preset: str = "tiny", device="cuda",
                          backends: Optional[Dict[str, Any]] = None,
                          replica_stats: Optional[list] = None
                          ) -> List[ResultRow]:
    """Interleaved A/B decode benches; ``only`` restricts bench_ids.
    ``preset`` is the decoder every leg serves (``"tiny"``, the
    reference's, or ``"base"``), ``device`` where its backends run.
    ``backends`` may map ``"decode"`` and ``"naive"`` to classes that
    replace :class:`BertDecodeBackend` and :class:`NaiveRecodeBackend`
    in the deployed replicas; ``replica_stats`` (a list) receives each
    replica's ``stats()`` as its deployment retires."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Serve

    decode_cls = (backends or {}).get("decode", BertDecodeBackend)
    naive_cls = (backends or {}).get("naive", NaiveRecodeBackend)
    kw = {"preset": preset, "device": str(device)}
    em = SuiteEmitter("decode", only)
    want = em.want

    def emit(bid, name, vals, unit="tokens/s", lower_is_better=False):
        return em.emit(bid, name, vals, unit=unit,
                       lower_is_better=lower_is_better)

    own_runtime = not rt.is_initialized()
    if own_runtime:
        rt.init(num_workers=2, memory_monitor=False)
    try:
        if any(want(b) for b in SCENARIO_BENCHES["window"]):
            _window_leg(em, trials, min_s, preset, device)

        base_ids = ("decode_naive_c1", "decode_paged_c1",
                    "decode_naive_c16", "decode_paged_c16",
                    "decode_speedup_c16", "decode_paged_c16_p50_ms",
                    "decode_paged_c16_p99_ms")
        run_base = any(want(b) for b in base_ids)
        run_spec = any(want(b) for b in SCENARIO_BENCHES["spec"])
        run_beam = any(want(b) for b in SCENARIO_BENCHES["beam"])
        run_prefix = any(want(b) for b in SCENARIO_BENCHES["prefix"])

        serve = Serve() if (run_base or run_spec or run_beam
                            or run_prefix) else None
        if run_base:
            # prompt bucket (one page) is the only prefill shape the
            # paged arm sees; the naive arm re-encodes through every
            # growth bucket
            buckets = list(range(16, MODEL_KW["max_len"] + 1, 16))
            serve.deploy("bench-decode", decode_cls,
                         num_replicas=1, max_retries=1,
                         init_kwargs=dict(MODEL_KW, **kw),
                         decode_policy=DecodePolicy(max_active=16),
                         warmup_shapes=[16])
            serve.deploy("bench-recode", naive_cls,
                         num_replicas=1, max_retries=1,
                         init_kwargs=dict(
                             max_len=MODEL_KW["max_len"],
                             page_size=MODEL_KW["page_size"],
                             max_new_tokens=MODEL_KW["max_new_tokens"],
                             **kw),
                         warmup_shapes=buckets)
            h_paged = serve.get_handle("bench-decode")
            h_naive = serve.get_handle("bench-recode")
            dep_paged = serve.get_deployment("bench-decode")

            # pre-warm both arms end to end (the first call builds what
            # the declared warmup missed) AND pin parity: same tokens
            out_p = h_paged.call(_prompt(0), timeout=300.0)
            out_n = h_naive.call(_prompt(0), timeout=300.0)
            if out_p["tokens"] != out_n["tokens"]:
                raise RuntimeError(
                    f"paged and re-encode arms diverged: "
                    f"{out_p['tokens']} vs {out_n['tokens']}")

            def cache_misses():
                st = rt.get(dep_paged._replicas[0].stats.remote(),
                            timeout=60.0)
                return st["compile_cache"]["misses"]

            misses_before = cache_misses()
            naive1, paged1, naive16, paged16, speedups = [], [], [], [], []
            p50s, p99s = [], []
            for _ in range(max(trials, 1)):
                # one A/B round: every leg sees the same host phase
                if want("decode_naive_c1") or want("decode_paged_c1"):
                    naive1.append(_token_loop(h_naive, 1, min_s))
                    paged1.append(_token_loop(h_paged, 1, min_s))
                samples: list = []
                a = _token_loop(h_naive, 16, min_s)
                b = _token_loop(h_paged, 16, min_s, samples=samples)
                naive16.append(a)
                paged16.append(b)
                speedups.append(b / a if a else float("inf"))
                p50, p99 = per_unit_percentiles(samples, (50, 99))
                p50s.append(p50)
                p99s.append(p99)
            misses_after = cache_misses()
            if misses_after != misses_before:
                # one step per (page config, max-batch): steps after
                # warmup must be cache hits, whatever the packing
                raise RuntimeError(
                    f"decode arm built a step during the timed rounds "
                    f"({misses_after - misses_before} new compile-cache "
                    "misses)")

            emit("decode_naive_c1", "decode re-encode baseline c1", naive1)
            emit("decode_paged_c1", "decode paged c1", paged1)
            emit("decode_naive_c16", "decode re-encode baseline c16",
                 naive16)
            row = emit("decode_paged_c16", "decode paged c16", paged16)
            if row is not None:
                row.extra["compile_cache_misses_during_rounds"] = (
                    misses_after - misses_before)
            emit("decode_speedup_c16",
                 "decode paged vs re-encode speedup c16", speedups,
                 unit="x")
            emit("decode_paged_c16_p50_ms", "decode paged c16 p50 latency",
                 p50s, unit="ms/token", lower_is_better=True)
            emit("decode_paged_c16_p99_ms", "decode paged c16 p99 latency",
                 p99s, unit="ms/token", lower_is_better=True)

            _retire(serve, "bench-decode", replica_stats)
            _retire(serve, "bench-recode", replica_stats)

        if run_spec:
            _spec_leg(em, serve, trials, min_s, kw, decode_cls,
                      replica_stats)
        if run_beam:
            _beam_leg(em, serve, trials, min_s, kw, decode_cls,
                      replica_stats)
        if run_prefix:
            _prefix_leg(em, serve, trials, min_s, kw, decode_cls,
                        replica_stats)
    finally:
        if own_runtime:
            rt.shutdown()
    rows = em.flush(quiet)
    for r in rows:
        r.extra.setdefault("preset", preset)
        r.extra.setdefault("model_device", str(device))
    return rows
