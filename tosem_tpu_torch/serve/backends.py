"""Model serving backends: BERT encode and decode.

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

:class:`BertDecodeBackend` serves decode over the paged KV cache
through the decode-client protocol a scheduler drives (``admit`` /
``step_batch`` / ``result`` / ``release`` / ``spill_seq`` /
``restore_seq`` / ``export_seq`` / ``import_seq``, idempotent per
(sequence, step)), plus a self-driven ``call``. Prefill runs the causal
flash kernel and writes per-layer K/V into the sequence's pages; each
greedy step runs the one-token paged kernel for the whole packed batch;
with the prefix cache on, a prompt whose leading whole pages are cached
forks those pages and feeds only the suffix, in chunks of up to
``suffix_q`` rows, through the multi-token paged kernel — each row
computing what a sequential one-token step would. Sliding-window and
speculative decode run every step through the multi-token kernel;
``n > 1`` requests decode as beam or sampling groups over copy-on-write
forks, and ``session`` requests keep their KV for the next turn (see
:class:`BertDecodeBackend`). Streaming a sequence to a peer's receiver
(``send_to``, ``send_seq``/``adopt_seq``) waits for the transport
(ROADMAP.md A11).

:class:`ShardedPagedDecodeBackend` and :class:`ShardedAttentionBackend`
are one logical replica over a ``dp x tp`` mesh of positions on one
device (:mod:`tosem_tpu_torch.parallel`), answering seeded workloads
that their ``reference()`` computes through the unsharded kernels;
deploying them across nodes (``ClusterServe.deploy(sharding=)``) waits
for ROADMAP.md A11.
"""
from __future__ import annotations

import collections
import dataclasses
import math
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


def _log_softmax(row):
    """fp64 log-softmax of one logits row (beam scores accumulate over
    many steps; fp32 cumulative sums drift across packings)."""
    z = np.asarray(row, np.float64)
    z = z - z.max()
    return z - np.log(np.exp(z).sum())


class _DecodeSeq:
    """One decoding sequence. ``tokens`` is prompt + everything sampled;
    the KV cache holds ``len(tokens) - 1`` positions (the newest token's
    K/V is written when it is fed, on the next step). ``outcomes[k]``
    memoizes step ``k``'s result, so a replayed (sequence, step) never
    touches the cache twice. ``budget`` is the request's own new-token
    cap; ``session`` its multi-turn key (its KV stays resident under
    that key when it retires)."""

    __slots__ = ("tokens", "prompt_len", "next_step", "done", "outcomes",
                 "budget", "session")

    def __init__(self, tokens: List[int], prompt_len: int,
                 budget: Optional[int] = None,
                 session: Optional[str] = None):
        self.tokens = tokens
        self.prompt_len = prompt_len
        self.next_step = 0
        self.done = False
        self.outcomes: List[Dict[str, Any]] = []
        self.budget = budget
        self.session = session


class NGramDrafter:
    """Prompt-lookup drafting: propose the tokens that followed the most
    recent earlier occurrence of the current suffix (bigram match first,
    unigram fallback, repeat-last when the history never repeats),
    scanning only the last ``lookback`` tokens. The accept-prefix and
    rollback contract makes any drafter safe: a wrong proposal costs
    speed, never correctness."""

    def __init__(self, lookback: int = 512):
        self.lookback = lookback

    def propose(self, tokens: List[int], k: int) -> List[int]:
        out: List[int] = []
        hist = list(tokens[-self.lookback:])
        for _ in range(max(k, 0)):
            nxt = self._predict(hist)
            out.append(nxt)
            hist.append(nxt)
        return out

    @staticmethod
    def _predict(hist: List[int]) -> int:
        if len(hist) >= 3:
            big = (hist[-2], hist[-1])
            for j in range(len(hist) - 3, -1, -1):
                if (hist[j], hist[j + 1]) == big:
                    return hist[j + 2]
        last = hist[-1]
        for j in range(len(hist) - 2, -1, -1):
            if hist[j] == last:
                return hist[j + 1]
        return last


class _Beam:
    """One branch of a beam-search / parallel-sampling group. ``cid`` is
    its cache sequence id (copy-on-write forked from the group root);
    ``done`` branches have released their cache already."""

    __slots__ = ("cid", "tokens", "logprob", "done")

    def __init__(self, cid, tokens: List[int], logprob: float):
        self.cid = cid
        self.tokens = tokens
        self.logprob = logprob
        self.done = False


class _DecodeGroup:
    """An N-branch request (``n > 1``): beam search (``beam=True``) or
    independent parallel sampling. The branches share the prompt's
    pages through ``PagedKVCache.fork``, diverge copy-on-write, and
    retire through page refcounts. Carries the same (step -> outcome)
    ledger as :class:`_DecodeSeq`."""

    __slots__ = ("beams", "prompt_len", "beam", "n", "temperature",
                 "seed", "next_step", "done", "outcomes", "forks",
                 "admit_token", "budget")

    def __init__(self, n: int, beam: bool, temperature: float, seed: int,
                 prompt_len: int, budget: Optional[int] = None):
        self.beams: List[_Beam] = []
        self.prompt_len = prompt_len
        self.beam = beam
        self.n = n
        self.temperature = temperature
        self.seed = seed
        self.next_step = 0
        self.done = False
        self.outcomes: List[Dict[str, Any]] = []
        self.forks = 0               # monotonic fork-id counter
        # the admit outcome's token, recorded: beam transitions rewrite
        # beams[0].tokens, so a replayed admit cannot recompute it
        self.admit_token: int = -1
        self.budget = budget


class _RowPlan:
    """One packed row of a decode step: ``fed`` tokens (1 for plain
    decode and beams, up to K for speculative drafts) at positions
    ``start .. start + kr - 1`` of cache sequence ``cid``."""

    __slots__ = ("cid", "fed", "start", "kr")

    def __init__(self, cid, fed: List[int], start: int):
        self.cid = cid
        self.fed = fed
        self.start = start
        self.kr = len(fed)


class BertDecodeBackend(CompiledBackendMixin):
    """Decode over the paged KV cache (see the module docstring).
    ``device`` defaults to ``"cuda"``; ``params`` loads a JAX-package
    parameter tree instead of the seed's random init.

    The decode-client protocol a scheduler drives: ``admit`` /
    ``step_batch`` / ``result`` / ``release`` / ``spill_seq`` /
    ``restore_seq`` / ``export_seq`` / ``import_seq`` / ``cache_stats``,
    each idempotent per (sequence id, step index). The modes on top of
    greedy decode:

    - ``window=W``: every step attends the ``W`` most recent positions
      through a narrow rolling block table with page offsets (B5), the
      prompt is prefilled through the same band (B1's schedule mode
      under ``LocalMask(W)``), and pages out of every future window are
      released, so a sequence holds at most ``ceil(W / page) + 2``
      pages between steps. The prefix cache stays off.
    - ``spec_k=k``: an :class:`NGramDrafter` proposes ``k - 1`` tokens
      and one k-row step (B5) scores them; the accepted prefix plus the
      target's own token commit and the rest rolls back through
      ``truncate``, so the stream is greedy's.
    - requests with ``{"n": N}`` (and ``"beam": True``,
      ``"temperature"``, ``"seed"``): beam search or parallel sampling,
      the branches sharing the prompt's pages copy-on-write.
    - requests with ``{"session": key}``: the finished sequence's KV
      stays resident under ``key`` (LRU, ``max_sessions``), and a next
      turn that extends its history prefills only the new suffix.
    """

    # consecutive pressured (token-less) retries a self-driven call()
    # tolerates before failing typed
    CALL_PRESSURE_LIMIT = 2000

    def __init__(self, preset: str = "tiny", seed: int = 0,
                 max_batch: int = 8, max_len: int = 128,
                 page_size: Optional[int] = None, num_pages: int = 64,
                 max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 backend: Optional[str] = None,
                 window: Optional[int] = None, spec_k: int = 0,
                 dim: int = 32, heads: int = 2, layers: int = 2,
                 mlp_dim: int = 64, prefix_cache: bool = True,
                 prefix_entries: int = 64, max_sessions: int = 16,
                 device="cuda", params=None):
        from tosem_tpu_torch.models.bert import BertConfig
        from tosem_tpu_torch.ops.flash_blocks import select_page_size
        from tosem_tpu_torch.serve.kv_cache import PagedKVCache
        from tosem_tpu_torch.serve.prefix_cache import PrefixCache
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
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 0 <= spec_k <= 8:
            raise ValueError(f"spec_k must be in [0, 8], got {spec_k}")
        self.window = window
        self.spec_k = 0 if spec_k <= 1 else int(spec_k)
        self.K = max(self.spec_k, 1)
        head_dim = cfg.dim // cfg.heads
        self.page_size = page_size or select_page_size(
            head_dim, cfg.dtype, max_len=cfg.max_len)
        self.max_pages = -(-cfg.max_len // self.page_size)
        if window is not None and self.spec_k and window < self.spec_k:
            raise ValueError(f"window={window} < spec_k={spec_k}")
        # a windowed sequence hands the kernel a narrow ROLLING table:
        # its in-window pages (<= ceil(W/page) + 2 after the post-step
        # release) plus the <= ceil(K/page) + 1 pages a step's K-token
        # extend adds before that release runs
        self.table_w = (min(-(-window // self.page_size)
                            + -(-self.K // self.page_size) + 3,
                            self.max_pages)
                        if window is not None else self.max_pages)
        self.model = _build_model(cfg, device, seed, params)
        self.device = self.model.device
        if window is not None:
            # a prompt longer than the window attends through the same
            # sliding band as the steps
            from tosem_tpu_torch.nn.attention import flash_attn_fn
            from tosem_tpu_torch.ops.mask_programs import LocalMask
            self._prefill = self.model.prefill_fn(
                attn_fn=flash_attn_fn(mask=LocalMask(window)))
        else:
            self._prefill = self.model.prefill_fn()
        self._general = bool(window is not None or self.spec_k)
        if self._general:
            self._step = self.model.decode_multi_fn(
                page_size=self.page_size, q_tokens=self.K, window=window,
                backend=backend)
        else:
            self._step = self.model.decode_step_fn(page_size=self.page_size,
                                                   backend=backend)
        self._drafter = NGramDrafter() if self.spec_k else None
        self.cache = PagedKVCache(num_pages, self.page_size,
                                  layers=cfg.layers, heads=cfg.heads,
                                  head_dim=head_dim, dtype=cfg.dtype,
                                  device=self.device)
        self._seqs: Dict[Any, _DecodeSeq] = {}
        self._groups: Dict[Any, _DecodeGroup] = {}
        # hand-off ledger: a sequence exported at admit leaves no _seqs
        # entry, so this bounded memo stops a replayed admit from
        # prefilling and exporting it again
        self._handed: "collections.OrderedDict" = collections.OrderedDict()
        self._spec_proposed = 0
        self._spec_accepted = 0
        # whole-page prefix reuse is off under a window: release_below
        # drops leading pages, and windowed prefill K/V depends on the
        # band
        self._prefix = (PrefixCache(self.cache, self.page_size,
                                    max_entries=prefix_entries)
                        if prefix_cache and window is None else None)
        self.max_sessions = max_sessions
        self._sessions: "collections.OrderedDict[Any, Dict[str, Any]]" = \
            collections.OrderedDict()
        self._session_n = 0
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
        self._session_hits = 0
        # prefixes adopted from another replica: stays 0 until the
        # transport path (ROADMAP.md A11) is ported
        self._prefix_remote_imports = 0
        self._call_n = 0
        self._lock = threading.RLock()
        self._tag = model_tag("bert_decode", cfg, seed,
                              page=self.page_size, pages=num_pages,
                              backend=backend or "auto",
                              window=window or 0, spec_k=self.spec_k)
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
                        (self.max_batch, self.table_w, self.page_size,
                         self.K), self.cfg.dtype)
        return self._steps.get_or_build(key, lambda: self._step)

    def _suffix_compiled(self):
        """The B=1 multi-token step that feeds a suffix in chunks of up
        to ``suffix_q`` rows over pages a prefix or session fork already
        shares (never windowed: the prefix cache is off under a
        window)."""
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
        """Reclaim the least valuable resident state: spill the LRU
        session first (restorable), then evict the LRU prefix entry
        (refcount-safe: live children keep their shared pages). True
        when something was freed. The caller holds ``_lock``."""
        for st in self._sessions.values():
            cid = st["cid"]
            if not self.cache.is_spilled(cid):
                try:
                    self.cache.spill(cid)
                    return True
                except KeyError:
                    continue
        return self._prefix is not None and self._prefix.evict_one()

    def _with_relief(self, fn):
        """Run ``fn``, retrying under :class:`CachePressure` while
        reclaimable prefix/session state remains."""
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

    def _prefill_bucket(self, T: int) -> int:
        """The padded prompt length: a page multiple; under a window
        also a multiple of the flash tiles where ``max_len`` allows it,
        since the windowed prefill runs B1's schedule mode, whose tiles
        must divide the length on the card. Pads sit past every real
        position, so no causal band lets them reach one."""
        from tosem_tpu_torch.ops.flash_blocks import FLASH_BK, FLASH_BQ
        bucket = -(-T // self.page_size) * self.page_size
        if self.window is not None:
            tile = math.lcm(FLASH_BQ, FLASH_BK)
            tiled = -(-bucket // tile) * tile
            if tiled <= self.cfg.max_len:
                bucket = tiled
        return bucket

    def _prefill_into_cache(self, seq_id, toks: List[int]):
        """Causal prefill over ``toks`` (pages already allocated) with
        the page write. Returns the last real token's logits row."""
        T = len(toks)
        bucket = self._prefill_bucket(T)
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
        return self._finished_at(len(seq.tokens), seq.prompt_len, token,
                                 budget=seq.budget)

    def _finished_at(self, n_tokens: int, prompt_len: int, token: int,
                     budget: Optional[int] = None) -> bool:
        gen = n_tokens - prompt_len
        cap = budget if budget is not None else self.max_new_tokens
        return (self.eos_id is not None and token == self.eos_id) \
            or gen >= cap or n_tokens >= self.cfg.max_len

    def _budget_of(self, request: Dict[str, Any]) -> Optional[int]:
        """The request's new-token budget (``{"max_new_tokens": n}``),
        clamped by the backend's cap; a value below 1 fails it."""
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

    def _release_floor(self, tokens_len: int) -> int:
        """The lowest cached position a future query's window can still
        see: the next step feeds ``tokens[-1]`` at ``tokens_len - 1``,
        whose window spans ``[tokens_len - window, tokens_len - 1]``."""
        return max(tokens_len - self.window, 0)

    def admit(self, seq_id, request: Dict[str, Any],
              export: bool = False,
              send_to: Optional[str] = None) -> Dict[str, Any]:
        """Validate, allocate pages, prefill (or fork a cached prefix or
        session and feed the suffix), take the first token. Raises
        :class:`~tosem_tpu_torch.serve.kv_cache.CachePressure` (pool
        full, nothing allocated) or ``ValueError`` (poison request).
        Idempotent: re-admitting a known sequence returns its outcome.
        A request with ``n > 1`` admits an N-branch group.

        ``export=True`` is the prefill tier's hand-off (disaggregated
        prefill): the outcome carries the freshly prefilled state
        (``"state"``, :meth:`export_seq`'s) and this replica releases its
        copy. ``send_to`` (streaming the pages to a peer's receiver)
        waits for the transport (ROADMAP.md A11)."""
        if send_to:
            raise _not_ported("streamed hand-off (send_to)",
                              "A11 transport")
        with self._lock:
            if seq_id in self._handed:    # replayed hand-off admit
                return dict(self._handed[seq_id])
            n = int(request.get("n", 1) or 1)
            if n > 1:
                out = self._admit_group(seq_id, request, n)
                if export and not out.get("done"):
                    out["state"] = self.export_seq(seq_id)
                    self.release(seq_id)
                    self._record_handoff(seq_id, out)
                return out
            if seq_id in self._seqs:              # at-least-once replay
                seq = self._seqs[seq_id]
                return {"token": seq.tokens[seq.prompt_len],
                        "done": seq.done and seq.next_step == 0}
            ids = [int(t) for t in request["ids"]]
            self._validate_ids(ids)
            budget = self._budget_of(request)
            session = request.get("session")
            # a session resume or prefix hit shares the computed pages
            # and prefills only the suffix, each suffix row computing
            # what a sequential step would
            reused = 0
            if session is not None:
                reused = self._session_resume(seq_id, session, ids)
            if reused == 0 and self._prefix is not None:
                ent = self._prefix.lookup(ids)
                if ent is not None:
                    self.cache.fork(ent.cid, seq_id)
                    reused = ent.depth * self.page_size
                    self._prefix_hits += 1
                    self._prefix_pages_reused += ent.depth
                elif session is None or session not in self._sessions:
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
                             budget=budget, session=session)
            seq.done = self._finished(seq, token)
            if self.window is not None:
                self.cache.release_below(
                    seq_id, self._release_floor(len(seq.tokens)))
            self._seqs[seq_id] = seq
            if self._prefix is not None:
                self._prefix.insert(ids, seq_id)
            if seq.done and session is not None:
                self._session_stash(seq_id, seq)
            out = {"token": token, "done": seq.done}
            if seq.done:
                # the final payload rides the outcome: retiring costs the
                # scheduler no extra round trip
                out["result"] = self._result_locked(seq)
            elif export:
                out["state"] = self.export_seq(seq_id)
                self.release(seq_id)
                self._record_handoff(seq_id, out)
            return out

    def _record_handoff(self, seq_id, out: Dict[str, Any]) -> None:
        """Memoize a hand-off admit's outcome (bounded FIFO), without its
        ``state``: a replay without state falls back to step-0
        re-admission, which determinism makes correct."""
        self._handed[seq_id] = {k: v for k, v in out.items()
                                if k != "state"}
        while len(self._handed) > 512:
            self._handed.popitem(last=False)

    # ------------------------------------------------- multi-turn sessions

    def _session_resume(self, seq_id, key, ids: List[int]) -> int:
        """Fork session ``key``'s stashed KV into ``seq_id`` when ``ids``
        extends the stashed history. Returns the cached positions reused
        (0 = cold admit: no stash, another history, or a lost spilled
        payload). The caller holds ``_lock``."""
        from tosem_tpu_torch.serve.kv_cache import (CachePressure,
                                                    PagesLostError)
        st = self._sessions.get(key)
        if st is None:
            return 0
        hist = st["tokens"]
        cached = len(hist) - 1
        if cached < 1 or len(ids) < len(hist) or ids[:len(hist)] != hist:
            return 0
        cid = st["cid"]
        if self.cache.is_spilled(cid):
            try:
                self._with_relief(lambda: self.cache.restore(cid))
            except (PagesLostError, CachePressure):
                # lost or unrestorable: cold prefill, and the retiring
                # turn stashes afresh
                del self._sessions[key]
                self._drop_session_state(st)
                return 0
        try:
            self.cache.fork(cid, seq_id)
        except KeyError:
            del self._sessions[key]
            return 0
        self._sessions.move_to_end(key)
        self._session_hits += 1
        return cached

    def _session_stash(self, seq_id, seq: _DecodeSeq) -> None:
        """Keep a finished sequence's KV resident under its session key
        (a copy-on-write fork, so retiring the request frees nothing
        shared), replacing the key's previous stash; LRU-bounded. The
        caller holds ``_lock``."""
        old = self._sessions.pop(seq.session, None)
        if old is not None:
            self._drop_session_state(old)
        self._session_n += 1
        cid = f"__session__/{self._session_n}"
        try:
            self.cache.fork(seq_id, cid)
        except (KeyError, ValueError):
            return
        self._sessions[seq.session] = {"cid": cid,
                                       "tokens": list(seq.tokens)}
        while len(self._sessions) > self.max_sessions:
            _, st = self._sessions.popitem(last=False)
            self._drop_session_state(st)

    def _drop_session_state(self, st: Dict[str, Any]) -> None:
        self._release_cid(st["cid"])

    def export_sessions(self) -> Dict[Any, Dict[str, Any]]:
        """The migratable stash of every resident session (what a drain
        relocates so multi-turn warmth survives it)."""
        from tosem_tpu_torch.serve.kv_cache import PagesLostError
        with self._lock:
            out: Dict[Any, Dict[str, Any]] = {}
            for key, st in self._sessions.items():
                try:
                    kv = self.cache.export_seq(st["cid"])
                except (KeyError, PagesLostError):
                    continue
                out[key] = {"tokens": list(st["tokens"]), "kv": kv}
            return out

    def import_session(self, key, state: Dict[str, Any]) -> None:
        """Adopt one exported session stash. Best effort: a pool too
        pressured to hold it drops the import instead of failing the
        drain."""
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        with self._lock:
            if key in self._sessions:
                return                      # at-least-once replay
            self._session_n += 1
            cid = f"__session__/{self._session_n}"
            try:
                self._with_relief(
                    lambda: self.cache.import_seq(cid, state["kv"]))
            except CachePressure:
                return
            self._sessions[key] = {"cid": cid,
                                   "tokens": list(state["tokens"])}
            while len(self._sessions) > self.max_sessions:
                _, st = self._sessions.popitem(last=False)
                self._drop_session_state(st)

    # ---------------------------------------------------------- groups

    def _admit_group(self, seq_id, request: Dict[str, Any],
                     n: int) -> Dict[str, Any]:
        if seq_id in self._groups:            # at-least-once replay
            g = self._groups[seq_id]
            return {"token": g.admit_token, "n_tokens": g.n,
                    "done": g.done and g.next_step == 0}
        if n > self.max_batch:
            raise ValueError(f"n={n} branches exceed max_batch="
                             f"{self.max_batch}")
        ids = [int(t) for t in request["ids"]]
        self._validate_ids(ids)
        group = _DecodeGroup(
            n=n, beam=bool(request.get("beam", False)),
            temperature=float(request.get("temperature", 1.0) or 1.0),
            seed=int(request.get("seed", 0) or 0), prompt_len=len(ids),
            budget=self._budget_of(request))
        root = f"{seq_id}#0"
        self.cache.create(root)
        try:
            self.cache.extend(root, len(ids))
            last = self._prefill_into_cache(root, ids)   # ~1x prefix
        except BaseException:
            self.cache.free(root)
            raise
        lp = _log_softmax(last)
        if group.beam:
            order = np.argsort(-lp)[:n]
            firsts = [(int(t), float(lp[t])) for t in order]
        else:
            firsts = [(self._sample(lp, group, i, 0), 0.0)
                      for i in range(n)]
            firsts = [(t, float(lp[t])) for t, _ in firsts]
        # fork every branch before settling any: a branch finishing on
        # its first token frees its cache, and the root must outlive
        # the later forks
        for i, (tok, tok_lp) in enumerate(firsts):
            cid = root if i == 0 else f"{seq_id}#f{i}"
            if i > 0:
                self.cache.fork(root, cid)
            group.beams.append(_Beam(cid, ids + [tok], tok_lp))
        for beam in group.beams:
            self._settle_branch(group, beam)
        group.forks = n
        group.done = all(b.done for b in group.beams)
        group.admit_token = group.beams[0].tokens[-1]
        self._groups[seq_id] = group
        out = {"token": group.admit_token, "n_tokens": n,
               "done": group.done}
        if group.done:
            out["result"] = self._group_result(group)
        return out

    def _sample(self, lp: np.ndarray, group: _DecodeGroup, branch: int,
                step: int) -> int:
        """A deterministic per-(seed, branch, step) draw from the
        temperature-scaled distribution, so sampling replays exactly."""
        rng = np.random.default_rng((group.seed, branch, step))
        t = max(group.temperature, 1e-4)
        z = lp.astype(np.float64) / t
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    # ------------------------------------------------------------ stepping

    def step_batch(self, seq_ids: List[Any],
                   step_idxs: List[int]) -> List[Dict[str, Any]]:
        """One decode iteration for the packed batch. Per-sequence
        outcomes: ``{"token", "done"[, "n_tokens", "tokens",
        "result"]}``, ``{"pressure": True}`` (no pages — nothing applied
        for that entry), ``{"pending": True}`` (unknown sequence), or the
        memoized outcome of an applied step. A speculative sequence may
        commit up to ``spec_k`` tokens; an N-branch group takes one row
        per live branch. Every step runs the same ``max_batch`` rows
        (idle rows have ``seq_len`` 0), so results never depend on the
        packing."""
        with self._lock:
            # the row budget is checked before any planning: planning
            # extends the cache, and raising after it would leave cache
            # lengths ahead of the token history on a retry
            rows_needed = 0
            for sid in seq_ids:
                if sid in self._groups:
                    rows_needed += sum(1 for b in self._groups[sid].beams
                                       if not b.done)
                else:
                    rows_needed += 1
            if rows_needed > self.max_batch:
                raise ValueError(
                    f"{rows_needed} packed rows exceed max_batch="
                    f"{self.max_batch} (group branches count)")
            outcomes: List[Optional[Dict[str, Any]]] = []
            plans: List[_RowPlan] = []
            pending: List[tuple] = []   # (outcome index, sid, plan range)
            for sid, step in zip(seq_ids, step_idxs):
                lo = len(plans)
                if sid in self._groups:
                    out = self._plan_group(sid, step, plans)
                elif sid not in self._seqs:
                    out = {"pending": True}
                else:
                    out = self._plan_seq(sid, step, plans)
                outcomes.append(out)
                if out is None:
                    pending.append((len(outcomes) - 1, sid,
                                    (lo, len(plans))))
            rows = self._run_step(plans) if plans else []
            for idx, sid, (lo, hi) in pending:
                if sid in self._groups:
                    outcomes[idx] = self._commit_group(sid, rows[lo:hi])
                else:
                    outcomes[idx] = self._commit_seq(sid, plans[lo],
                                                     rows[lo])
            return outcomes

    def _replay_or_advance(self, rec, step: int, sid) -> Optional[Dict]:
        """The memoized outcome of a replayed step, the terminal outcome
        of a done record, or None when the step must run."""
        if step < rec.next_step:
            return rec.outcomes[step]
        if step > rec.next_step:
            raise RuntimeError(f"step {step} for {sid!r} skips ahead of "
                               f"{rec.next_step} (scheduler bug)")
        if rec.done:
            if isinstance(rec, _DecodeGroup):
                return {"token": rec.beams[0].tokens[-1], "done": True}
            return {"token": rec.tokens[-1], "done": True}
        return None

    def _plan_seq(self, sid, step: int,
                  plans: List[_RowPlan]) -> Optional[Dict[str, Any]]:
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        seq = self._seqs[sid]
        out = self._replay_or_advance(seq, step, sid)
        if out is not None:
            return out
        L = len(seq.tokens)
        drafts: List[int] = []
        kr = 1
        if self.spec_k:
            kr = min(self.K, self.cfg.max_len - (L - 1))
            drafts = self._drafter.propose(seq.tokens, kr - 1)
        try:
            start, _ = self._extend_with_relief(sid, kr)
        except CachePressure:
            return {"pressure": True}
        plans.append(_RowPlan(sid, [seq.tokens[-1]] + drafts, start))
        return None

    def _commit_seq(self, sid, plan: _RowPlan,
                    logits_rows) -> Dict[str, Any]:
        """Greedy accept-prefix: row r scores position ``start + r + 1``
        exactly as a sequential step would, so the matched drafts plus
        the target's own next token reproduce plain greedy; the rejected
        tail rolls back through ``truncate``."""
        seq = self._seqs[sid]
        L = len(seq.tokens)
        kr = plan.kr
        drafts = plan.fed[1:]
        targets = [int(np.argmax(logits_rows[r])) for r in range(kr)]
        j = 0
        while j < len(drafts) and drafts[j] == targets[j]:
            j += 1
        # always >= 1 committed token: the accepted drafts, then the
        # target's token at the first divergence (or after them all)
        committed = drafts[:j] + [targets[j]]
        if drafts:
            self._spec_proposed += len(drafts)
            self._spec_accepted += j
        done = False
        for tok in committed:
            seq.tokens.append(tok)
            if self._finished(seq, tok):
                done = True
                break
        # the cache holds L - 1 + kr positions, the committed sequence
        # needs len(tokens) - 1
        if len(seq.tokens) - 1 < L - 1 + kr:
            self.cache.truncate(sid, len(seq.tokens) - 1)
        if self.window is not None and not done:
            self.cache.release_below(
                sid, self._release_floor(len(seq.tokens)))
        out = {"token": seq.tokens[-1], "done": done}
        m = len(seq.tokens) - L
        if m != 1:
            out["n_tokens"] = m
            # a streaming consumer needs every committed token
            out["tokens"] = list(seq.tokens[L:])
        seq.done = done
        if done:
            out["result"] = self._result_locked(seq)
            if seq.session is not None:
                self._session_stash(sid, seq)
        seq.outcomes.append(out)
        seq.next_step += 1
        return out

    def _plan_group(self, sid, step: int,
                    plans: List[_RowPlan]) -> Optional[Dict[str, Any]]:
        from tosem_tpu_torch.serve.kv_cache import CachePressure
        g = self._groups[sid]
        out = self._replay_or_advance(g, step, sid)
        if out is not None:
            return out
        live = [b for b in g.beams if not b.done]
        extended: List[_Beam] = []
        try:
            for b in live:
                self._extend_with_relief(b.cid, 1)
                extended.append(b)
        except CachePressure:
            # all-or-nothing for the whole group, so a retried step
            # starts from the same state
            for b in extended:
                self.cache.truncate(b.cid, len(b.tokens) - 1)
            return {"pressure": True}
        for b in live:
            plans.append(_RowPlan(b.cid, [b.tokens[-1]],
                                  len(b.tokens) - 1))
        return None

    def _commit_group(self, sid, rows) -> Dict[str, Any]:
        g = self._groups[sid]
        live = [b for b in g.beams if not b.done]
        lps = [_log_softmax(rows[i][0]) for i in range(len(live))]
        step_no = g.next_step + 1          # the admit took draw 0
        if g.beam:
            self._beam_select(sid, g, live, lps)
        else:
            for i, b in enumerate(live):
                branch = g.beams.index(b)
                tok = self._sample(lps[i], g, branch, step_no)
                b.tokens.append(tok)
                b.logprob += float(lps[i][tok])
                self._settle_branch(g, b)
        g.done = all(b.done for b in g.beams)
        best = max(g.beams, key=lambda b: b.logprob)
        out = {"token": best.tokens[-1], "done": g.done,
               "n_tokens": len(live)}
        if g.done:
            out["result"] = self._group_result(g)
        g.outcomes.append(out)
        g.next_step += 1
        return out

    def _settle_branch(self, g: _DecodeGroup, b: _Beam) -> None:
        """After an append: a finished branch frees its cache now
        (shared prefix pages survive for its siblings); a live windowed
        branch releases below its floor."""
        if self._finished_at(len(b.tokens), g.prompt_len, b.tokens[-1],
                             budget=g.budget):
            b.done = True
            self.cache.free(b.cid)
        elif self.window is not None:
            self.cache.release_below(
                b.cid, self._release_floor(len(b.tokens)))

    def _beam_select(self, sid, g: _DecodeGroup, live: List[_Beam],
                     lps) -> None:
        """One beam-search transition: the global top-|live|
        continuations by cumulative logprob. A parent chosen twice forks
        (copy-on-write); an unchosen parent's pages roll back through a
        refcount free."""
        width = len(live)
        cands = []                          # (score, live idx, token)
        for i, b in enumerate(live):
            lp = lps[i]
            for t in np.argsort(-lp)[:width]:
                cands.append((b.logprob + float(lp[t]), i, int(t)))
        # deterministic tie-break: score desc, then branch, then token
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        chosen = cands[:width]
        used = {i for _, i, _ in chosen}
        for i, b in enumerate(live):
            if i not in used:
                self.cache.free(b.cid)      # dropped beam: rollback
        parents = [(b.cid, list(b.tokens)) for b in live]
        taken: Dict[int, int] = {}
        assigned = []                       # (slot, cid, tokens, score)
        for slot, (score, i, tok) in enumerate(chosen):
            cid, toks = parents[i]
            if i in taken:
                g.forks += 1
                new_cid = f"{sid}#f{g.forks}"
                self.cache.fork(cid, new_cid)
                cid = new_cid
            else:
                taken[i] = 1
            assigned.append((slot, cid, toks + [tok], score))
        # settle after every fork landed: a finished first child frees
        # the parent's cache name, which a later fork still needs
        for slot, cid, toks, score in assigned:
            b = live[slot]
            b.cid = cid
            b.tokens = toks
            b.logprob = score
            self._settle_branch(g, b)

    def _group_result(self, g: _DecodeGroup) -> Dict[str, Any]:
        branches = sorted(g.beams, key=lambda b: -b.logprob)
        entries = [{"tokens": list(b.tokens),
                    "generated": list(b.tokens[g.prompt_len:]),
                    "prompt_len": g.prompt_len,
                    "logprob": b.logprob} for b in branches]
        best = entries[0]
        key = "beams" if g.beam else "samples"
        return {"tokens": best["tokens"], "generated": best["generated"],
                "prompt_len": g.prompt_len, key: entries}

    def _run_step(self, plans: List[_RowPlan]) -> List[np.ndarray]:
        """Run the step over the packed rows; returns each plan's fp32
        logits rows ``[kr, vocab]``."""
        B = self.max_batch
        t = self._tensor
        tables = np.zeros((B, self.table_w), np.int32)
        lens = np.zeros((B,), np.int32)
        pools = (self.cache.k_pool, self.cache.v_pool)
        if not self._general:
            ids_t = np.zeros((B,), np.int32)
            positions = np.zeros((B,), np.int32)
            for row, p in enumerate(plans):
                ids_t[row] = p.fed[0]
                positions[row] = p.start
                tables[row] = self.cache.block_table(p.cid, self.table_w)
                lens[row] = p.start + 1
            logits, _, _ = self._step_compiled()(
                t(ids_t), t(positions), *pools, t(tables), t(lens))
            lg = logits[:len(plans)].float().cpu().numpy()
            return [lg[row:row + 1] for row in range(len(plans))]
        K = self.K
        ids_t = np.zeros((B, K), np.int32)
        positions = np.zeros((B, K), np.int32)
        q_rows = np.ones((B,), np.int32)
        offs = np.zeros((B,), np.int32)
        for row, p in enumerate(plans):
            kr = p.kr
            ids_t[row, :kr] = p.fed
            ids_t[row, kr:] = p.fed[-1]        # padding mirrors the last
            positions[row, :kr] = np.arange(p.start, p.start + kr)
            positions[row, kr:] = p.start + kr - 1
            tables[row] = self.cache.block_table(p.cid, self.table_w)
            lens[row] = p.start + kr
            q_rows[row] = kr
            offs[row] = self.cache.page_offset(p.cid)
        logits, _, _ = self._step_compiled()(
            t(ids_t), t(positions), *pools, t(tables), t(lens), t(q_rows),
            t(offs))
        lg = logits[:len(plans)].float().cpu().numpy()
        return [lg[row, :plans[row].kr] for row in range(len(plans))]

    @staticmethod
    def _result_locked(seq: _DecodeSeq) -> Dict[str, Any]:
        return {"tokens": list(seq.tokens),
                "generated": list(seq.tokens[seq.prompt_len:]),
                "prompt_len": seq.prompt_len}

    def result(self, seq_id) -> Dict[str, Any]:
        with self._lock:
            if seq_id in self._groups:
                return self._group_result(self._groups[seq_id])
            return self._result_locked(self._seqs[seq_id])

    # ------------------------------------------------- release and spill

    def release(self, seq_id) -> None:
        with self._lock:
            group = self._groups.pop(seq_id, None)
            if group is not None:
                for b in group.beams:
                    if not b.done:
                        self._release_cid(b.cid)
                return
            if seq_id in self._seqs:
                self._release_cid(seq_id)
                del self._seqs[seq_id]

    def _release_cid(self, cid) -> None:
        if self.cache.is_spilled(cid):
            self.cache.drop_spilled(cid)
        else:
            self.cache.free(cid)

    def _live_cids(self, seq_id) -> List[tuple]:
        """(cache id, cached-token history) of each live cache sequence
        of a request: one for a plain sequence, one per live branch."""
        if seq_id in self._groups:
            return [(b.cid, b.tokens[:-1])
                    for b in self._groups[seq_id].beams if not b.done]
        return [(seq_id, self._seqs[seq_id].tokens[:-1])]

    def spill_seq(self, seq_id) -> None:
        with self._lock:
            for cid, _ in self._live_cids(seq_id):
                if not self.cache.is_spilled(cid):
                    self.cache.spill(cid)

    def restore_seq(self, seq_id) -> None:
        """Bring a spilled request back (every live branch): byte for
        byte when the payload survived, else by re-prefilling the cache
        from the branch's token history. Raises
        :class:`~tosem_tpu_torch.serve.kv_cache.CachePressure` when the
        pool has no room (nothing changed for the branch that hit it)."""
        with self._lock:
            for cid, cached in self._live_cids(seq_id):
                self._restore_cid(cid, cached)

    def _restore_cid(self, cid, cached: List[int]) -> None:
        from tosem_tpu_torch.serve.kv_cache import (CachePressure,
                                                    PagesLostError)
        if not self.cache.is_spilled(cid):
            return
        try:
            self.cache.restore(cid)
        except PagesLostError:
            # re-prefill the FULL history: a windowed position's K/V
            # depends on its whole in-window context at every layer
            need = -(-len(cached) // self.page_size)
            if need > self.cache.num_pages:
                # can never fit this pool (a windowed pool is sized for
                # the window, not the history): fail terminally
                raise PagesLostError(
                    f"re-prefill of {cid!r} needs {need} pages but the "
                    f"pool holds {self.cache.num_pages}; sequence is "
                    "unrecoverable on this replica")
            # capacity first: CachePressure must leave the spilled entry
            # as it was, so a retry finds it
            if need > self.cache.stats()["pages_free"]:
                raise CachePressure(
                    f"re-prefill of {cid!r} needs {need} pages; "
                    "parked until something retires")
            self.cache.drop_spilled(cid)
            self.cache.create(cid)
            try:
                self.cache.extend(cid, len(cached))
                self._prefill_into_cache(cid, cached)
                if self.window is not None:
                    self.cache.release_below(
                        cid, self._release_floor(len(cached) + 1))
            except BaseException:
                self.cache.free(cid)
                raise

    # ------------------------------------------------------ live migration
    #
    # A sequence (or branch group) moves between replicas mid-decode and
    # continues from its current step: the pages travel in the cache's
    # wire format beside the token history and the step ledger, so a
    # step committed on the source just before the export replays from
    # the imported ledger on the destination.

    def list_seqs(self) -> List[Any]:
        """Request ids holding decode state here — what a drain must
        move. Self-driven ``call()`` sequences are left out: their
        driving thread lives on this replica."""
        with self._lock:
            return sorted(
                [s for s in list(self._seqs) + list(self._groups)
                 if not str(s).startswith("__call__/")], key=str)

    def export_seq(self, seq_id) -> Dict[str, Any]:
        """The full migratable state of one request: its bookkeeping and
        each live branch's KV payload (a spilled branch exports its
        stored payload). The state here is unchanged: the caller releases
        it only after the destination's import succeeded."""
        with self._lock:
            if seq_id in self._groups:
                g = self._groups[seq_id]
                return {
                    "kind": "group", "n": g.n, "beam": g.beam,
                    "temperature": g.temperature, "seed": g.seed,
                    "prompt_len": g.prompt_len,
                    "next_step": g.next_step, "done": g.done,
                    "outcomes": list(g.outcomes), "forks": g.forks,
                    "admit_token": g.admit_token, "budget": g.budget,
                    "branches": [{
                        "cid": b.cid, "tokens": list(b.tokens),
                        "logprob": b.logprob, "done": b.done,
                        "kv": (None if b.done
                               else self.cache.export_seq(b.cid)),
                    } for b in g.beams],
                }
            seq = self._seqs[seq_id]
            return {"kind": "seq", "tokens": list(seq.tokens),
                    "prompt_len": seq.prompt_len,
                    "next_step": seq.next_step, "done": seq.done,
                    "outcomes": list(seq.outcomes),
                    "budget": seq.budget,
                    "kv": self.cache.export_seq(seq_id)}

    def import_seq(self, seq_id, state: Dict[str, Any]) -> None:
        """Adopt an exported request, all or nothing: a KV header
        mismatch raises :class:`~tosem_tpu_torch.serve.kv_cache.
        KVWireError` and pressure :class:`~tosem_tpu_torch.serve.
        kv_cache.CachePressure`, leaving nothing changed (a group's
        imported branches roll back). Idempotent per sequence id."""
        with self._lock:
            if seq_id in self._seqs or seq_id in self._groups:
                return                    # at-least-once replay
            if state.get("kind") == "seq":
                self.cache.import_seq(seq_id, state["kv"])
                seq = _DecodeSeq(list(state["tokens"]),
                                 int(state["prompt_len"]),
                                 budget=state.get("budget"))
                seq.next_step = int(state["next_step"])
                seq.done = bool(state["done"])
                seq.outcomes = list(state["outcomes"])
                self._seqs[seq_id] = seq
                return
            if state.get("kind") != "group":
                raise ValueError(
                    f"unknown decode-state kind {state.get('kind')!r}")
            imported: List[Any] = []
            try:
                for br in state["branches"]:
                    if not br["done"]:
                        self.cache.import_seq(br["cid"], br["kv"])
                        imported.append(br["cid"])
            except BaseException:
                for cid in imported:
                    self.cache.free(cid)
                raise
            g = _DecodeGroup(n=int(state["n"]), beam=bool(state["beam"]),
                             temperature=float(state["temperature"]),
                             seed=int(state["seed"]),
                             prompt_len=int(state["prompt_len"]),
                             budget=state.get("budget"))
            g.next_step = int(state["next_step"])
            g.done = bool(state["done"])
            g.outcomes = list(state["outcomes"])
            g.forks = int(state["forks"])
            g.admit_token = int(state["admit_token"])
            for br in state["branches"]:
                beam = _Beam(br["cid"], list(br["tokens"]),
                             float(br["logprob"]))
                beam.done = bool(br["done"])
                g.beams.append(beam)
            self._groups[seq_id] = g

    def prefix_digest(self) -> List[List[Any]]:
        """Bounded ``[depth, n_tokens, hash]`` entries for this replica's
        hottest prefixes (what a router's longest-prefix routing reads)."""
        if self._prefix is None:
            return []
        return self._prefix.digest()

    # ---------------------------------------------- synchronous decode

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
                    # concurrent calls hold pages and free them as they
                    # retire: retry the same step, a bounded number of
                    # times
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
            out["spec_proposed"] = self._spec_proposed
            out["spec_accepted"] = self._spec_accepted
            out["prefix_hits"] = self._prefix_hits
            out["prefix_misses"] = self._prefix_misses
            out["prefix_pages_reused"] = self._prefix_pages_reused
            out["prefix_pages_prefilled"] = self._prefix_pages_prefilled
            out["prefill_tokens"] = self._prefill_tokens
            out["reused_tokens"] = self._reused_tokens
            out["session_hits"] = self._session_hits
            out["sessions"] = len(self._sessions)
            out["prefix_remote_imports"] = self._prefix_remote_imports
            if self._prefix is not None:
                out.update(self._prefix.stats())
        return out

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out.update(self.cache_stats())
        with self._lock:
            out["decode_sequences"] = len(self._seqs) + len(self._groups)
        return out


# ---------------------------------------------------------------------------
# sharded replicas


def _positions(dp: int, tp: int, batch: int, heads: int, device):
    """The ``(dp, tp)`` mesh of a sharded replica, every position on
    ``device``, after the divisibility checks."""
    from tosem_tpu_torch.ops.common import resolve_device
    from tosem_tpu_torch.parallel.flash import dp_tp_mesh
    if batch % dp:
        raise ValueError(f"batch={batch} not divisible by dp={dp}")
    if heads % tp:
        raise ValueError(f"heads={heads} not divisible by tp={tp}")
    dev = resolve_device(device)
    return dev, dp_tp_mesh(dp, tp, devices=[dev] * (dp * tp))


class ShardedPagedDecodeBackend:
    """Sharded DECODE replica: one logical replica running paged decode
    attention over a ``dp x tp`` mesh whose positions all sit on
    ``device`` (default ``"cuda"``), through
    :func:`~tosem_tpu_torch.parallel.flash.sharded_paged_attention`: KV
    pools sharded over the model axis, the batch over dp, block tables
    and seq lens following the batch. Requests are ``{"seed": int[,
    "q_tokens": k, "offsets": bool]}``: the replica derives a paged fp32
    workload from the seed with numpy, byte for byte the JAX package's,
    so :meth:`reference` computes the same inputs through the unsharded
    kernel, and the two agree bit for bit (decode attention reduces only
    within a (batch row, head) cell)."""

    def __init__(self, dp: int = 1, tp: int = 1, batch: int = 4,
                 heads: int = 4, head_dim: int = 16, pages: int = 16,
                 page_size: int = 8, table_w: int = 4,
                 window: Optional[int] = None,
                 backend: Optional[str] = None, device="cuda"):
        from tosem_tpu_torch.parallel.flash import sharded_paged_attention
        self.device, self._mesh = _positions(dp, tp, batch, heads, device)
        self.dp, self.tp = dp, tp
        self.dims = dict(batch=batch, heads=heads, head_dim=head_dim,
                         pages=pages, page_size=page_size,
                         table_w=table_w)
        self.window = window
        self.backend = backend
        self._run = sharded_paged_attention(self._mesh, window=window,
                                            backend=backend)

    @staticmethod
    def _workload(req_seed: int, *, batch, heads, head_dim, pages,
                  page_size, table_w, q_tokens=0, offsets=False):
        """Deterministic paged-decode inputs: a pure function of the
        seed, byte-equal wherever it is computed."""
        rng = np.random.default_rng(0xDEC0DE + req_seed)
        if q_tokens:
            q = rng.standard_normal((batch, q_tokens, heads, head_dim)
                                    ).astype(np.float32)
        else:
            q = rng.standard_normal((batch, heads, head_dim)
                                    ).astype(np.float32)
        kp = rng.standard_normal((pages, page_size, heads, head_dim)
                                 ).astype(np.float32)
        vp = rng.standard_normal((pages, page_size, heads, head_dim)
                                 ).astype(np.float32)
        bt = rng.integers(0, pages, (batch, table_w)).astype(np.int32)
        po = (rng.integers(0, 2, (batch,)).astype(np.int32)
              if offsets else None)
        lo = 1 if not q_tokens else max(q_tokens, 1)
        sl = rng.integers(lo, table_w * page_size + 1,
                          (batch,)).astype(np.int32)
        if po is not None:
            sl = np.minimum(sl + po * page_size,
                            (po + table_w) * page_size).astype(np.int32)
        kr = (rng.integers(1, q_tokens + 1, (batch,)).astype(np.int32)
              if q_tokens else None)
        return q, kp, vp, bt, sl, kr, po

    @classmethod
    def _tensors(cls, request, device, dims):
        arrays = cls._workload(
            int(request.get("seed", 0)), **dims,
            q_tokens=int(request.get("q_tokens", 0) or 0),
            offsets=bool(request.get("offsets", False)))
        return [None if a is None else torch.as_tensor(a, device=device)
                for a in arrays]

    def call(self, request: Dict[str, Any]) -> Dict[str, Any]:
        q, kp, vp, bt, sl, kr, po = self._tensors(request, self.device,
                                                  self.dims)
        out = self._run(q, kp, vp, bt, sl, q_rows=kr, page_offsets=po)
        return {"out": out.cpu().numpy(), "mesh": [self.dp, self.tp],
                "devices": self._mesh.size, "cards": self._mesh.cards()}

    def warmup(self, shapes: Sequence) -> Dict[str, Any]:
        self.call({"seed": 0})
        return {"warmed": 1}

    @classmethod
    def reference(cls, request: Dict[str, Any],
                  window: Optional[int] = None, device="cuda", **dims):
        """The unsharded kernel on the same inputs: what a dp x tp
        response must equal bit for bit."""
        from tosem_tpu_torch.ops.common import resolve_device
        from tosem_tpu_torch.ops.paged_attention import paged_attention
        full = dict(batch=4, heads=4, head_dim=16, pages=16,
                    page_size=8, table_w=4)
        full.update(dims)
        q, kp, vp, bt, sl, kr, po = cls._tensors(
            request, resolve_device(device), full)
        return paged_attention(q, kp, vp, bt, sl, q_rows=kr, window=window,
                               page_offsets=po).cpu().numpy()


class ShardedAttentionBackend:
    """Sharded serve replica: ONE logical replica spanning a ``dp x tp``
    mesh whose positions all sit on ``device`` (default ``"cuda"``),
    answering through :func:`~tosem_tpu_torch.parallel.flash.
    sharded_flash_attention`: batch over dp, heads over tp, each position
    the unmodified flash forward (B1). Requests are ``{"seed": int}``:
    the replica derives fp32 (q, k, v) from the seed with numpy, byte for
    byte the JAX package's, so :meth:`reference` runs the same inputs
    through the unsharded kernel and the two agree bit for bit (sharding
    splits batch and heads, never the softmax's reduction axis)."""

    def __init__(self, dp: int = 1, tp: int = 1, batch: int = 4,
                 heads: int = 4, seq: int = 128, dim: int = 64,
                 causal: bool = True, seed: int = 0, device="cuda"):
        from tosem_tpu_torch.parallel.flash import sharded_flash_attention
        self.device, self._mesh = _positions(dp, tp, batch, heads, device)
        self.dp, self.tp = dp, tp
        self.batch, self.heads, self.seq, self.dim = batch, heads, seq, dim
        self.causal = causal
        self.seed = seed
        self._run = sharded_flash_attention(self._mesh, causal=causal)

    @staticmethod
    def _qkv(batch: int, heads: int, seq: int, dim: int, req_seed: int):
        """Deterministic request inputs: a pure function of the seed, so
        replica and reference build byte-equal arrays independently."""
        rng = np.random.default_rng(0xC1A0 + req_seed)
        shape = (batch, seq, heads, dim)
        return (rng.standard_normal(shape, dtype=np.float32),
                rng.standard_normal(shape, dtype=np.float32),
                rng.standard_normal(shape, dtype=np.float32))

    def call(self, request: Dict[str, Any]) -> Dict[str, Any]:
        q, k, v = (torch.as_tensor(a, device=self.device) for a in self._qkv(
            self.batch, self.heads, self.seq, self.dim,
            int(request.get("seed", 0))))
        out = self._run(q, k, v)
        return {"out": out.cpu().numpy(), "mesh": [self.dp, self.tp],
                "devices": self._mesh.size, "cards": self._mesh.cards()}

    def warmup(self, shapes: Sequence) -> Dict[str, Any]:
        """One call (``shapes`` is ignored: this backend serves one
        static shape)."""
        self.call({"seed": 0})
        return {"warmed": 1}

    @classmethod
    def reference(cls, request: Dict[str, Any], batch: int = 4,
                  heads: int = 4, seq: int = 128, dim: int = 64,
                  causal: bool = True, device="cuda"):
        """The unsharded kernel on the same inputs, no mesh: what a
        dp x tp response must equal bit for bit."""
        from tosem_tpu_torch.ops.common import resolve_device
        from tosem_tpu_torch.ops.flash_attention import flash_attention
        dev = resolve_device(device)
        q, k, v = (torch.as_tensor(a, device=dev) for a in cls._qkv(
            batch, heads, seq, dim, int(request.get("seed", 0))))
        return flash_attention(q, k, v, None, causal,
                               layout="bthd").cpu().numpy()
