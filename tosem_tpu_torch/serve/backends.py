"""Model serving backends: BERT encode and greedy decode.

Counterpart of the BERT backends in ``tosem_tpu/serve/backends.py``.

:class:`BertEncodeBackend` pads variable-length requests to one
``(max_batch, bucket)`` batch with a key-padding mask and runs the
encoder; with ``use_flash`` the padding rides the flash kernel as segment
ids. Every batch is padded to ``max_batch`` rows, so a request's result
never depends on what it was batched with. With ``local_window`` or
``doc_len`` a long bucket (``data.feeding.sparse_mask_spec``) rides a
block-sparse mask program (the symmetric band ``local:W:W-1`` or the
block-diagonal ``doc:L``) through the kernels' schedule mode, with the
padding as segment ids on top; short buckets keep the dense program.

:class:`BertDecodeBackend` serves greedy decode over the paged KV cache
through the decode-client protocol a scheduler drives (``admit`` /
``step_batch`` / ``result`` / ``release``, idempotent per (sequence,
step)), plus a self-driven ``call``. Prefill runs the causal flash
kernel and writes per-layer K/V into the sequence's pages; each decode
step runs the one-token paged kernel for the whole packed batch; with
the prefix cache on, a prompt whose leading whole pages are cached forks
those pages and feeds only the suffix, in chunks of up to ``suffix_q``
rows, through the multi-token paged kernel — each row computing what a
sequential one-token step would.

Not ported yet (each raises ``NotImplementedError``): sliding-window
decode, speculative decode (``spec_k``), ``n > 1`` beam/sampling groups,
sessions, and export/send/spill of sequences.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from tosem_tpu_torch.serve.compile_cache import StepCache, shape_key

# bucket granularity of padded encode batches (one cached callable per
# bucket); the flash kernel itself takes any length
FLASH_ALIGN = 128


def model_tag(name: str, cfg: Any, seed: int, **extra: Any) -> str:
    """Cache-key fingerprint of a model's step callables (config, seed,
    routing flags), the JAX package's own. Keys stay inside one backend's
    :class:`StepCache`, so the weights need no name in them."""
    fields = (dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg)
              else dict(vars(cfg)))
    sig = ",".join(f"{k}={fields[k]}" for k in sorted(fields))
    ex = "".join(f";{k}={v}" for k, v in sorted(extra.items()))
    return f"{name}({sig};seed={seed}{ex})"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


class CompiledBackendMixin:
    """Shared step-cache surface: subclasses set ``self._tag`` and their
    own ``self._steps`` (a :class:`StepCache`), and implement
    ``_compiled(pad_to)``."""

    _tag: str
    _steps: StepCache

    def warmup(self, shapes: Sequence[int]) -> Dict[str, Any]:
        """Build one step callable per declared bucket."""
        for pad_to in shapes:
            self._compiled(int(pad_to))
        return {"warmed": len(list(shapes)), "cache": self._steps.stats()}

    def stats(self) -> Dict[str, Any]:
        return {"compile_cache": self._steps.stats()}


def _build_model(cfg, device, seed, params):
    from tosem_tpu_torch.models.bert import Bert
    model = Bert(cfg, device=device, seed=seed)
    if params is not None:
        from tosem_tpu_torch.models.convert import load_bert_params
        load_bert_params(model, params)
    return model


class BertEncodeBackend(CompiledBackendMixin):
    """``{"ids": [int, ...]}`` -> ``{"pooled": np.ndarray[dim], "len"}``
    (fp32 mean over real tokens), or ``{"encoding": [T_i, dim]}`` with
    ``pooled=False``. ``params`` is a JAX-package parameter tree of numpy
    arrays to load instead of the seed's random init. ``local_window``
    and ``doc_len`` route long buckets onto a block-sparse schedule (see
    the module docstring)."""

    def __init__(self, preset: str = "tiny", seed: int = 0,
                 max_batch: int = 8, use_flash: bool = True,
                 pooled: bool = True, max_len: int = 128,
                 local_window: Optional[int] = None,
                 doc_len: Optional[int] = None, device="cuda",
                 params=None):
        from tosem_tpu_torch.models.bert import BertConfig
        from tosem_tpu_torch.nn.attention import flash_attn_fn
        if preset == "base":
            cfg = BertConfig.base()
        else:
            cfg = BertConfig(vocab_size=128, max_len=max_len, dim=32,
                             heads=2, layers=2, mlp_dim=64, dropout=0.0)
        self.cfg = cfg
        self.max_batch = max_batch
        self.pooled = pooled
        self.local_window = local_window
        self.doc_len = doc_len
        self._use_flash = use_flash
        self.model = _build_model(cfg, device, seed, params)
        self.device = self.model.device
        self._fwd = self.model.encode_fn(
            attn_fn=flash_attn_fn() if use_flash else None)
        # pad target -> (encode fn over its mask program, mask signature)
        self._sparse_fwd: Dict[int, Any] = {}
        self._tag = model_tag("bert_encode", cfg, seed, use_flash=use_flash,
                              local_window=local_window, doc_len=doc_len)
        self._steps = StepCache()

    @staticmethod
    def length_of(request: Dict[str, Any]) -> int:
        return len(request["ids"])

    def _fwd_for(self, pad_to: int):
        """(encode fn, mask signature) for a bucket: the feeding layer's
        rule decides whether this pad target rides a sparse schedule; the
        mask and its encode fn are built once per pad target."""
        from tosem_tpu_torch.data.feeding import sparse_mask_spec
        spec = None
        if self._use_flash:
            spec = sparse_mask_spec(pad_to, local_window=self.local_window,
                                    doc_len=self.doc_len)
        if spec is None:
            return self._fwd, ""
        if pad_to not in self._sparse_fwd:
            from tosem_tpu_torch.nn.attention import flash_attn_fn
            from tosem_tpu_torch.ops.mask_programs import mask_from_spec
            mask = mask_from_spec(spec, pad_to)
            self._sparse_fwd[pad_to] = (
                self.model.encode_fn(attn_fn=flash_attn_fn(mask=mask)),
                mask.signature())
        return self._sparse_fwd[pad_to]

    def _compiled(self, pad_to: int):
        fwd, sig = self._fwd_for(pad_to)
        key = shape_key(self._tag + (f";mask={sig}" if sig else ""),
                        (self.max_batch, pad_to), self.cfg.dtype)
        return self._steps.get_or_build(key, lambda: fwd)

    def call(self, request: Dict[str, Any]) -> Any:
        return self.call_batch([request])[0]

    def call_batch(self, requests: List[Dict[str, Any]],
                   pad_to: Optional[int] = None) -> List[Any]:
        from tosem_tpu_torch.models.bert import pad_ids_batch
        if len(requests) > self.max_batch:
            raise ValueError(
                f"batch of {len(requests)} exceeds max_batch="
                f"{self.max_batch}; deploy with max_batch_size <= "
                "the backend's max_batch")
        for r in requests:
            ids = r["ids"]
            # reject poison inputs here, per request: an out-of-vocab id
            # would make the embedding gather raise for the whole batch,
            # and an empty sequence has no real key to attend to
            if len(ids) == 0:
                raise ValueError("empty ids sequence")
            if min(ids) < 0 or max(ids) >= self.cfg.vocab_size:
                raise ValueError(
                    f"token id out of range [0, {self.cfg.vocab_size})")
        if pad_to is None:
            longest = max(len(r["ids"]) for r in requests)
            pad_to = -(-longest // FLASH_ALIGN) * FLASH_ALIGN
        # position embeddings cover max_len only: a longer request fails
        # its own batch in pad_ids_batch
        pad_to = min(int(pad_to), self.cfg.max_len)
        ids, mask, lengths = pad_ids_batch(
            [r["ids"] for r in requests], pad_to,
            pad_batch_to=self.max_batch)
        enc = self._compiled(pad_to)(
            torch.as_tensor(ids, device=self.device),
            torch.as_tensor(mask, device=self.device))
        enc = enc.float().cpu().numpy()
        out = []
        for i, _ in enumerate(requests):
            n = int(lengths[i])
            row = enc[i, :n]
            if self.pooled:
                out.append({"pooled": row.mean(axis=0), "len": n})
            else:
                out.append({"encoding": row, "len": n})
        return out

    def stats(self) -> Dict[str, Any]:
        from tosem_tpu_torch.nn.attention import FLASH_DISPATCH_COUNTS
        out = super().stats()
        out["flash_dispatch"] = dict(FLASH_DISPATCH_COUNTS)
        return out


# ---------------------------------------------------------------------------
# generative decode


class _DecodeSeq:
    """One decoding sequence. ``tokens`` is prompt + everything sampled;
    the KV cache holds ``len(tokens) - 1`` positions (the newest token's
    K/V is written when it is fed, on the next step). ``outcomes[k]``
    memoizes step ``k``'s result, so a replayed (sequence, step) never
    touches the cache twice."""

    __slots__ = ("tokens", "prompt_len", "next_step", "done", "outcomes",
                 "budget")

    def __init__(self, tokens: List[int], prompt_len: int,
                 budget: Optional[int] = None):
        self.tokens = tokens
        self.prompt_len = prompt_len
        self.next_step = 0
        self.done = False
        self.outcomes: List[Dict[str, Any]] = []
        self.budget = budget


class BertDecodeBackend(CompiledBackendMixin):
    """Greedy decode over the paged KV cache (see the module docstring).
    ``device`` defaults to ``"cuda"``; ``params`` loads a JAX-package
    parameter tree instead of the seed's random init."""

    CALL_PRESSURE_LIMIT = 2000

    def __init__(self, preset: str = "tiny", seed: int = 0,
                 max_batch: int = 8, max_len: int = 128,
                 page_size: Optional[int] = None, num_pages: int = 64,
                 max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 backend: Optional[str] = None,
                 window: Optional[int] = None, spec_k: int = 0,
                 dim: int = 32, heads: int = 2, layers: int = 2,
                 mlp_dim: int = 64, prefix_cache: bool = True,
                 prefix_entries: int = 64, device="cuda", params=None):
        from tosem_tpu_torch.models.bert import BertConfig
        from tosem_tpu_torch.ops.flash_blocks import select_page_size
        from tosem_tpu_torch.serve.kv_cache import PagedKVCache
        from tosem_tpu_torch.serve.prefix_cache import PrefixCache
        if window is not None:
            raise _not_ported("sliding-window decode", "A6/A7 window")
        if spec_k > 1:
            raise _not_ported("speculative decode (spec_k)", "A7 spec")
        if preset == "base":
            cfg = BertConfig.base()
        else:
            cfg = BertConfig(vocab_size=128, max_len=max_len, dim=dim,
                             heads=heads, layers=layers, mlp_dim=mlp_dim,
                             dropout=0.0)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.backend = backend
        head_dim = cfg.dim // cfg.heads
        self.page_size = page_size or select_page_size(
            head_dim, cfg.dtype, max_len=cfg.max_len)
        self.max_pages = -(-cfg.max_len // self.page_size)
        self.model = _build_model(cfg, device, seed, params)
        self.device = self.model.device
        self._prefill = self.model.prefill_fn()
        self._step = self.model.decode_step_fn(page_size=self.page_size,
                                               backend=backend)
        self.cache = PagedKVCache(num_pages, self.page_size,
                                  layers=cfg.layers, heads=cfg.heads,
                                  head_dim=head_dim, dtype=cfg.dtype,
                                  device=self.device)
        self._seqs: Dict[Any, _DecodeSeq] = {}
        self._prefix = (PrefixCache(self.cache, self.page_size,
                                    max_entries=prefix_entries)
                        if prefix_cache else None)
        self._suffix_step = None
        # suffix-prefill chunk width: the multi-token kernel and its
        # plain version both take any number of query rows
        self.suffix_q = 64
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_pages_reused = 0
        self._prefix_pages_prefilled = 0
        self._prefill_tokens = 0
        self._reused_tokens = 0
        self._call_n = 0
        self._lock = threading.RLock()
        self._tag = model_tag("bert_decode", cfg, seed,
                              page=self.page_size, pages=num_pages,
                              backend=backend or "auto")
        self._steps = StepCache()

    # --------------------------------------------------------- step callables

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def _prefill_compiled(self, pad_to: int):
        """Causal prefill + page write for one prompt bucket: pages/rows
        name the slots of the REAL positions only, so pad positions
        never land in a page. Like every cached step it takes the pools
        as arguments and closes over nothing but this backend's model."""
        key = shape_key(self._tag + ";prefill", (1, pad_to), self.cfg.dtype)
        prefill = self._prefill

        def fused(ids, mask, k_pool, v_pool, pages, rows):
            logits, k, v = prefill(ids, mask)
            n = pages.shape[0]
            k_pool[:, pages, rows] = k[:, 0, :n].to(k_pool.dtype)
            v_pool[:, pages, rows] = v[:, 0, :n].to(v_pool.dtype)
            return logits
        return self._steps.get_or_build(key, lambda: fused)

    def _step_compiled(self):
        key = shape_key(self._tag + ";step",
                        (self.max_batch, self.max_pages, self.page_size, 1),
                        self.cfg.dtype)
        return self._steps.get_or_build(key, lambda: self._step)

    def _suffix_compiled(self):
        """The B=1 multi-token step that feeds a suffix in chunks of up
        to ``suffix_q`` rows over pages a prefix fork already shares."""
        if self._suffix_step is None:
            self._suffix_step = self.model.decode_multi_fn(
                page_size=self.page_size, q_tokens=self.suffix_q,
                backend=self.backend)
        key = shape_key(self._tag + ";suffix",
                        (1, self.max_pages, self.page_size, self.suffix_q),
                        self.cfg.dtype)
        return self._steps.get_or_build(key, lambda: self._suffix_step)

    def warmup(self, shapes: Sequence[int]) -> Dict[str, Any]:
        for pad_to in shapes:
            self._prefill_compiled(int(pad_to))
        self._step_compiled()
        extra = 1
        if self._prefix is not None:
            self._suffix_compiled()
            extra = 2
        return {"warmed": len(list(shapes)) + extra,
                "cache": self._steps.stats()}

    def _suffix_feed(self, seq_id, toks: List[int], start: int):
        """Prefill positions ``[start, len(toks))`` through the chunked
        multi-token step (pages for the whole suffix extended up front).
        Returns the last token's logits row (fp32 numpy)."""
        self._extend_with_relief(seq_id, len(toks) - start)
        fn = self._suffix_compiled()
        Q = self.suffix_q
        last = None
        pos = start
        while pos < len(toks):
            n = min(Q, len(toks) - pos)
            chunk = toks[pos:pos + n]
            ids_t = np.full((1, Q), chunk[-1], np.int32)
            ids_t[0, :n] = chunk
            positions = np.full((1, Q), pos + n - 1, np.int32)
            positions[0, :n] = np.arange(pos, pos + n)
            tables = self.cache.block_table(seq_id, self.max_pages)[None, :]
            logits, _, _ = fn(
                self._tensor(ids_t), self._tensor(positions),
                self.cache.k_pool, self.cache.v_pool, self._tensor(tables),
                self._tensor(np.asarray([pos + n], np.int32)),
                self._tensor(np.asarray([n], np.int32)),
                self._tensor(np.zeros((1,), np.int32)))
            last = logits[0, n - 1].float().cpu().numpy()
            pos += n
        return last

    # -------------------------------------------- pressure relief (reclaim)

    def _relieve_pressure(self) -> bool:
        """Evict the LRU prefix entry (refcount-safe: live children keep
        their shared pages). True when something was freed."""
        return self._prefix is not None and self._prefix.evict_one()

    def _with_relief(self, fn):
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        while True:
            try:
                return fn()
            except CachePressure:
                if not self._relieve_pressure():
                    raise

    def _extend_with_relief(self, seq_id, n_tokens: int):
        return self._with_relief(
            lambda: self.cache.extend(seq_id, n_tokens))

    # ------------------------------------------------------- decode client

    def _prefill_into_cache(self, seq_id, toks: List[int]):
        """Causal prefill over ``toks`` (pages already allocated) with
        the page write. Returns the last real token's logits row."""
        T = len(toks)
        bucket = -(-T // self.page_size) * self.page_size
        ids = np.zeros((1, bucket), np.int32)
        mask = np.zeros((1, bucket), np.int32)
        ids[0, :T] = toks
        mask[0, :T] = 1
        pages = np.asarray(self.cache.pages_of(seq_id), np.int64)
        pos = np.arange(T)
        logits = self._prefill_compiled(bucket)(
            self._tensor(ids), self._tensor(mask), self.cache.k_pool,
            self.cache.v_pool, self._tensor(pages[pos // self.page_size]),
            self._tensor(pos % self.page_size))
        return logits[0, T - 1].float().cpu().numpy()

    def _finished(self, seq: _DecodeSeq, token: int) -> bool:
        gen = len(seq.tokens) - seq.prompt_len
        cap = seq.budget if seq.budget is not None else self.max_new_tokens
        return (self.eos_id is not None and token == self.eos_id) \
            or gen >= cap or len(seq.tokens) >= self.cfg.max_len

    def _budget_of(self, request: Dict[str, Any]) -> Optional[int]:
        raw = request.get("max_new_tokens")
        if raw is None:
            return None
        n = int(raw)
        if n < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n}")
        return min(n, self.max_new_tokens)

    def _validate_ids(self, ids: List[int]) -> None:
        if not ids:
            raise ValueError("empty ids sequence")
        if min(ids) < 0 or max(ids) >= self.cfg.vocab_size:
            raise ValueError(
                f"token id out of range [0, {self.cfg.vocab_size})")
        if len(ids) >= self.cfg.max_len:
            raise ValueError(
                f"prompt length {len(ids)} >= max_len {self.cfg.max_len}")

    def admit(self, seq_id, request: Dict[str, Any],
              export: bool = False,
              send_to: Optional[str] = None) -> Dict[str, Any]:
        """Validate, allocate pages, prefill (or fork a cached prefix and
        feed the suffix), take the first greedy token. Raises
        :class:`~tosem_tpu_torch.serve.kv_cache.CachePressure` (pool
        full, nothing allocated) or ``ValueError`` (poison request).
        Idempotent: re-admitting a known sequence returns its outcome."""
        if export or send_to:
            raise _not_ported("prefill handoff (export/send_to)",
                              "A7 export/send")
        if int(request.get("n", 1) or 1) > 1:
            raise _not_ported("n > 1 beam/sampling groups", "A7 groups")
        if request.get("session") is not None:
            raise _not_ported("multi-turn sessions", "A7 sessions")
        with self._lock:
            if seq_id in self._seqs:              # at-least-once replay
                seq = self._seqs[seq_id]
                return {"token": seq.tokens[seq.prompt_len],
                        "done": seq.done and seq.next_step == 0}
            ids = [int(t) for t in request["ids"]]
            self._validate_ids(ids)
            budget = self._budget_of(request)
            reused = 0
            if self._prefix is not None:
                ent = self._prefix.lookup(ids)
                if ent is not None:
                    self.cache.fork(ent.cid, seq_id)
                    reused = ent.depth * self.page_size
                    self._prefix_hits += 1
                    self._prefix_pages_reused += ent.depth
                else:
                    self._prefix_misses += 1
            try:
                if reused:
                    last = self._suffix_feed(seq_id, ids, reused)
                else:
                    self.cache.create(seq_id)
                    self._extend_with_relief(seq_id, len(ids))
                    last = self._prefill_into_cache(seq_id, ids)
            except BaseException:
                self.cache.free(seq_id)
                raise
            self._prefill_tokens += len(ids) - reused
            self._reused_tokens += reused
            self._prefix_pages_prefilled += \
                -(-(len(ids) - reused) // self.page_size)
            token = int(np.argmax(last))
            seq = _DecodeSeq(tokens=ids + [token], prompt_len=len(ids),
                             budget=budget)
            seq.done = self._finished(seq, token)
            self._seqs[seq_id] = seq
            if self._prefix is not None:
                self._prefix.insert(ids, seq_id)
            out = {"token": token, "done": seq.done}
            if seq.done:
                out["result"] = self._result_locked(seq)
            return out

    def step_batch(self, seq_ids: List[Any],
                   step_idxs: List[int]) -> List[Dict[str, Any]]:
        """One decode iteration for the packed batch. Per-sequence
        outcomes: ``{"token", "done"[, "result"]}``, ``{"pressure":
        True}`` (no page — nothing applied), ``{"pending": True}``
        (unknown sequence), or the memoized outcome of an applied step.
        Every step runs the same ``max_batch`` rows (idle rows have
        ``seq_len`` 0), so results never depend on the packing."""
        with self._lock:
            if len(seq_ids) > self.max_batch:
                raise ValueError(f"{len(seq_ids)} packed rows exceed "
                                 f"max_batch={self.max_batch}")
            outcomes: List[Optional[Dict[str, Any]]] = []
            plans: List[tuple] = []           # (outcome index, sid, start)
            for sid, step in zip(seq_ids, step_idxs):
                if sid not in self._seqs:
                    outcomes.append({"pending": True})
                    continue
                out = self._plan_seq(sid, step)
                if isinstance(out, int):
                    plans.append((len(outcomes), sid, out))
                    out = None
                outcomes.append(out)
            if plans:
                rows = self._run_step([(sid, start)
                                       for _, sid, start in plans])
                for (idx, sid, _), row in zip(plans, rows):
                    outcomes[idx] = self._commit_seq(sid, row)
            return outcomes

    def _plan_seq(self, sid, step: int):
        """The memoized/terminal/pressure outcome, or the position the
        step feeds (an int) when the step must run."""
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        seq = self._seqs[sid]
        if step < seq.next_step:
            return seq.outcomes[step]
        if step > seq.next_step:
            raise RuntimeError(f"step {step} for {sid!r} skips ahead of "
                               f"{seq.next_step} (scheduler bug)")
        if seq.done:
            return {"token": seq.tokens[-1], "done": True}
        try:
            start, _ = self._extend_with_relief(sid, 1)
        except CachePressure:
            return {"pressure": True}
        return start

    def _commit_seq(self, sid, logits_row) -> Dict[str, Any]:
        seq = self._seqs[sid]
        token = int(np.argmax(logits_row))
        seq.tokens.append(token)
        done = self._finished(seq, token)
        out = {"token": token, "done": done}
        seq.done = done
        if done:
            out["result"] = self._result_locked(seq)
        seq.outcomes.append(out)
        seq.next_step += 1
        return out

    def _run_step(self, rows: List[tuple]) -> List[np.ndarray]:
        """Run the one-token step over the packed rows ``(sid, start)``;
        returns each row's fp32 logits."""
        B = self.max_batch
        ids_t = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, self.max_pages), np.int32)
        lens = np.zeros((B,), np.int32)
        for row, (sid, start) in enumerate(rows):
            ids_t[row] = self._seqs[sid].tokens[-1]
            positions[row] = start
            tables[row] = self.cache.block_table(sid, self.max_pages)
            lens[row] = start + 1
        logits, _, _ = self._step_compiled()(
            self._tensor(ids_t), self._tensor(positions),
            self.cache.k_pool, self.cache.v_pool, self._tensor(tables),
            self._tensor(lens))
        lg = logits[:len(rows)].float().cpu().numpy()
        return [lg[row] for row in range(len(rows))]

    @staticmethod
    def _result_locked(seq: _DecodeSeq) -> Dict[str, Any]:
        return {"tokens": list(seq.tokens),
                "generated": list(seq.tokens[seq.prompt_len:]),
                "prompt_len": seq.prompt_len}

    def result(self, seq_id) -> Dict[str, Any]:
        with self._lock:
            return self._result_locked(self._seqs[seq_id])

    def release(self, seq_id) -> None:
        with self._lock:
            if self._seqs.pop(seq_id, None) is not None:
                self.cache.free(seq_id)

    def call(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Self-driven single-request decode (admit -> step loop ->
        result)."""
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        with self._lock:
            self._call_n += 1
            sid = f"__call__/{self._call_n}"
        out = self.admit(sid, request)
        step = 0
        stalls = 0
        try:
            while not out.get("done"):
                out = self.step_batch([sid], [step])[0]
                if out.get("pressure"):
                    stalls += 1
                    if stalls > self.CALL_PRESSURE_LIMIT:
                        raise CachePressure(
                            f"sequence {sid} made no progress in "
                            f"{self.CALL_PRESSURE_LIMIT} pressured retries")
                    time.sleep(0.005)
                    continue
                stalls = 0
                if out.get("pending"):
                    raise RuntimeError(f"sequence {sid} no longer lives on "
                                       "this replica (released mid-call)")
                step += 1
            return out.get("result") or self.result(sid)
        finally:
            self.release(sid)

    def cache_stats(self) -> Dict[str, int]:
        out = dict(self.cache.stats())
        with self._lock:
            out["prefix_hits"] = self._prefix_hits
            out["prefix_misses"] = self._prefix_misses
            out["prefix_pages_reused"] = self._prefix_pages_reused
            out["prefix_pages_prefilled"] = self._prefix_pages_prefilled
            out["prefill_tokens"] = self._prefill_tokens
            out["reused_tokens"] = self._reused_tokens
            if self._prefix is not None:
                out.update(self._prefix.stats())
        return out

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out.update(self.cache_stats())
        with self._lock:
            out["decode_sequences"] = len(self._seqs)
        return out
