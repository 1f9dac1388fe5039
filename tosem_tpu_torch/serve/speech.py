"""Streaming speech recognition behind the C ABI, and its serve backends.

Counterpart of ``tosem_tpu/serve/speech.py``, over
:class:`tosem_tpu_torch.models.speech.SpeechModel`:

- :class:`CStreamingModel` registers the model's streaming functions as
  the callback vtable of ``native/speech_api.cpp`` (``ctypes.CFUNCTYPE``)
  and drives recognition through its C calls (``sp_create_stream`` /
  ``sp_feed`` / ``sp_intermediate`` / ``sp_finish``), the surface of the
  reference's ``native_client/deepspeech.h``. The callbacks run on the C
  caller's thread: each keeps its tensors (on the model's device) to
  itself and hands the C layer host copies of the logits.
- :class:`SpeechStreamBackend` multiplexes C-API streams behind session
  ids; :class:`StreamingClient` recovers a stream from a lost replica by
  replaying its acknowledged audio to a fresh session.
- :class:`SpeechBatchBackend` transcribes whole utterances in padding
  buckets, every batch padded to ``max_batch`` rows.
- :class:`SpeechDecodeBackend` streams utterances through the
  decode-client protocol of :class:`~tosem_tpu_torch.serve.batching.
  DecodeQueue` (``admit`` / ``step_batch`` / ``result`` / ``release``,
  idempotent per (sequence, step)) with static ``(max_batch, chunk)``
  shapes; the LSTM carry is its cache.

The backends use the port's :class:`~tosem_tpu_torch.serve.backends.
CompiledBackendMixin` and its step cache where the JAX package
AOT-compiles. Each takes ``device`` (default ``"cuda"``) and ``params``,
a JAX-package parameter tree of numpy arrays to load instead of the
seed's random init.
"""
from __future__ import annotations

import ctypes
import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tosem_tpu_torch.serve.backends import CompiledBackendMixin, model_tag
from tosem_tpu_torch.serve.compile_cache import CompileCache, shape_key

_STREAM_INIT = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p)
_STREAM_FREE = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)
_INFER = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                          ctypes.POINTER(ctypes.c_float),
                          ctypes.POINTER(ctypes.c_int32))
_FLUSH = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_float),
                          ctypes.POINTER(ctypes.c_int32))
# the out buffer must be POINTER(c_char), not c_char_p: ctypes hands a
# c_char_p callback argument to Python as an immutable bytes copy, so
# writes through it never reach the C buffer
_DECODE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                           ctypes.POINTER(ctypes.c_char), ctypes.c_int32)

# the label alphabet of the serving configs, cut to the model's classes
SERVE_ALPHABET = "abcdefghijklmnopqrstuvwxyz' -"


def _bind(lib):
    lib.sp_create_model.restype = ctypes.c_void_p
    lib.sp_create_model.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32,
                                    _STREAM_INIT, _STREAM_FREE, _INFER,
                                    _FLUSH, _DECODE, ctypes.c_void_p]
    lib.sp_free_model.argtypes = [ctypes.c_void_p]
    lib.sp_create_stream.restype = ctypes.c_void_p
    lib.sp_create_stream.argtypes = [ctypes.c_void_p]
    lib.sp_free_stream.argtypes = [ctypes.c_void_p]
    lib.sp_feed.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
    lib.sp_intermediate.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int32]
    lib.sp_finish.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_int32]
    lib.sp_stream_frames_emitted.argtypes = [ctypes.c_void_p]
    lib.sp_stream_frames_emitted.restype = ctypes.c_int32
    return lib


def _logsumexp(arr: np.ndarray) -> np.ndarray:
    m = arr.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(arr - m).sum(axis=-1, keepdims=True))


def greedy_ctc_text(logits: np.ndarray, alphabet: str, blank: int) -> str:
    """Greedy CTC collapse (repeat-merge then blank-drop)."""
    ids = np.asarray(logits).argmax(-1)
    out = []
    prev = -1
    for i in ids:
        if i != prev and i != blank:
            out.append(alphabet[i] if i < len(alphabet) else "?")
        prev = i
    return "".join(out)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def build_speech_model(cfg_name: str = "tiny", *, seed: int = 0,
                       device="cuda", params=None):
    """The serving configs: ``"tiny"`` (``SpeechConfig.tiny()``) or the
    full-width ``SpeechConfig()``; ``params`` loads a JAX-package tree."""
    from tosem_tpu_torch.models.speech import SpeechConfig, SpeechModel
    cfg = SpeechConfig.tiny() if cfg_name == "tiny" else SpeechConfig()
    model = SpeechModel(cfg, device=device, seed=seed)
    if params is not None:
        from tosem_tpu_torch.models.convert import load_speech_params
        load_speech_params(model, params)
    model.eval()
    return model


class CStreamingModel:
    """DeepSpeech-native-client surface over the port's streaming model."""

    def __init__(self, model, alphabet: str, chunk_frames: int = 16):
        from tosem_tpu_torch.native import load_library
        self.model = model
        self.alphabet = alphabet
        cfg = model.cfg
        self.lib = _bind(load_library("speech_api"))
        self._states: Dict[int, Any] = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()

        def stream_init(_):
            sid = next(self._next)
            with self._lock:
                self._states[sid] = model.streaming_init(batch=1)
            return sid

        def stream_free(_, sid):
            with self._lock:
                self._states.pop(sid, None)

        def emit(logits, out_p, out_n, cap):
            arr = _host(logits[0])
            out = np.ctypeslib.as_array(out_p, (cap, cfg.n_classes))
            out[:arr.shape[0]] = arr
            out_n[0] = arr.shape[0]

        def infer(_, sid, frames_p, n_frames, out_p, out_n):
            try:
                x = np.ctypeslib.as_array(
                    frames_p, (n_frames, cfg.n_input)).copy()
                with self._lock:
                    state = self._states[sid]
                with torch.no_grad():
                    logits, state = model.streaming_step(
                        state, torch.from_numpy(x[None]).to(model.device))
                with self._lock:
                    self._states[sid] = state
                emit(logits, out_p, out_n, n_frames + cfg.n_context)
                return 0
            except Exception:
                return -1

        def flush(_, sid, out_p, out_n):
            try:
                with self._lock:
                    state = self._states[sid]
                with torch.no_grad():
                    logits, state = model.streaming_flush(state)
                with self._lock:
                    self._states[sid] = state
                emit(logits, out_p, out_n, cfg.n_context + 1)
                return 0
            except Exception:
                return -1

        self._scorer = None
        self._beam_width = 16

        def decode(_, logits_p, n_frames, out, cap):
            try:
                arr = np.ctypeslib.as_array(
                    logits_p, (n_frames, cfg.n_classes))
                # refcounted: the lock covers the pointer grab only, so a
                # concurrent disable defers the native free until the
                # last decode holding the scorer releases it
                scorer = self._acquire_scorer()
                try:
                    if scorer is not None:
                        from tosem_tpu_torch.data.audio import labels_to_text
                        from tosem_tpu_torch.ops import ctc
                        labels, _ = ctc.beam_search_decode(
                            arr - _logsumexp(arr), blank=cfg.blank,
                            beam_width=self._beam_width, scorer=scorer)
                        text = labels_to_text(labels, alphabet)
                    else:
                        text = greedy_ctc_text(arr, alphabet, cfg.blank)
                finally:
                    if scorer is not None:
                        self._release_scorer(scorer)
                data = text.encode()[:cap - 1]
                ctypes.memmove(out, data + b"\0", len(data) + 1)
                return 0
            except Exception:
                return -1

        # the callback objects live as long as the model
        self._cbs = (_STREAM_INIT(stream_init), _STREAM_FREE(stream_free),
                     _INFER(infer), _FLUSH(flush), _DECODE(decode))
        self._model_p = self.lib.sp_create_model(
            cfg.n_input, cfg.n_classes, chunk_frames, cfg.n_context,
            *self._cbs, None)
        if not self._model_p:
            raise RuntimeError("sp_create_model failed")

    # -- external scorer (DS_EnableExternalScorer) -------------------------

    def _acquire_scorer(self):
        with self._lock:
            sc = self._scorer
            if sc is not None:
                sc._refs = getattr(sc, "_refs", 0) + 1
            return sc

    def _release_scorer(self, sc) -> None:
        with self._lock:
            sc._refs -= 1
            close_now = getattr(sc, "_retired", False) and sc._refs == 0
        if close_now:
            sc.close()

    def _retire(self, sc) -> None:
        """Close a swapped-out scorer once no decode holds it."""
        with self._lock:
            sc._retired = True
            close_now = getattr(sc, "_refs", 0) == 0
        if close_now:
            sc.close()

    def enable_external_scorer(self, path: str, alpha: float = 1.8,
                               beta: float = 0.8,
                               beam_width: int = 16) -> None:
        """Attach an n-gram scorer package: decodes switch from greedy to
        LM-scored beam search. Word boundaries use this model's alphabet
        (one without a space gets end-of-utterance scoring only); a
        package stamped with another alphabet is refused."""
        from tosem_tpu_torch.data.scorer import read_scorer_alphabet
        from tosem_tpu_torch.ops.ctc import Scorer
        stamped = read_scorer_alphabet(path)
        if stamped is not None and stamped != self.alphabet:
            raise ValueError(
                f"scorer package was built with alphabet {stamped!r}, "
                f"model uses {self.alphabet!r}")
        space = (self.alphabet.index(" ") if " " in self.alphabet else -1)
        new = Scorer(path, alpha=alpha, beta=beta, space_index=space)
        # load first, then swap: a failed load keeps the old scorer
        with self._lock:
            old, self._scorer = self._scorer, new
            self._beam_width = beam_width
        if old is not None:
            self._retire(old)

    def disable_external_scorer(self) -> None:
        with self._lock:
            old, self._scorer = self._scorer, None
        if old is not None:
            self._retire(old)

    # -- the four-call C surface -------------------------------------------

    def create_stream(self) -> int:
        p = self.lib.sp_create_stream(self._model_p)
        if not p:
            raise RuntimeError("sp_create_stream failed")
        return p

    def feed(self, stream: int, frames: np.ndarray) -> None:
        f = np.ascontiguousarray(frames, np.float32)
        rc = self.lib.sp_feed(
            stream, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            f.shape[0])
        if rc != 0:
            raise RuntimeError(f"sp_feed rc={rc}")

    def intermediate(self, stream: int, cap: int = 4096) -> str:
        buf = ctypes.create_string_buffer(cap)
        rc = self.lib.sp_intermediate(stream, buf, cap)
        if rc != 0:
            raise RuntimeError(f"sp_intermediate rc={rc}")
        return buf.value.decode()

    def finish(self, stream: int, cap: int = 4096) -> str:
        buf = ctypes.create_string_buffer(cap)
        rc = self.lib.sp_finish(stream, buf, cap)
        self.lib.sp_free_stream(stream)   # freed even on failure
        if rc != 0:
            raise RuntimeError(f"sp_finish rc={rc}")
        return buf.value.decode()

    def abort(self, stream: int) -> None:
        """Free a stream without decoding (a failed or abandoned one)."""
        self.lib.sp_free_stream(stream)

    def close(self) -> None:
        self.disable_external_scorer()
        if self._model_p:
            self.lib.sp_free_model(self._model_p)
            self._model_p = None


class SpeechStreamBackend:
    """Serve backend: ``{op: create|feed|intermediate|finish}`` session
    calls over :class:`CStreamingModel` streams."""

    def __init__(self, cfg_name: str = "tiny", seed: int = 0,
                 chunk_frames: int = 8, device="cuda", params=None):
        model = build_speech_model(cfg_name, seed=seed, device=device,
                                   params=params)
        alphabet = SERVE_ALPHABET[:model.cfg.n_classes - 1]
        self.cm = CStreamingModel(model, alphabet, chunk_frames=chunk_frames)
        self._sessions: Dict[str, int] = {}

    def call(self, request: Dict[str, Any]) -> Any:
        op = request["op"]
        if op == "create":
            sid = request["session"]
            old = self._sessions.pop(sid, None)
            if old is not None:       # a client's recovery re-creates
                self.cm.abort(old)
            self._sessions[sid] = self.cm.create_stream()
            return {"ok": True}
        stream = self._sessions.get(request["session"])
        if stream is None:
            raise KeyError(f"unknown session {request['session']!r} "
                           "(replica restarted?)")
        if op == "feed":
            self.cm.feed(stream, np.asarray(request["frames"], np.float32))
            return {"ok": True}
        if op == "intermediate":
            return {"text": self.cm.intermediate(stream)}
        if op == "finish":
            # finish() frees the C stream even when it fails: the session
            # goes with it, or the next call would use a dangling pointer
            del self._sessions[request["session"]]
            return {"text": self.cm.finish(stream)}
        raise ValueError(f"unknown op {op!r}")


class SpeechBatchBackend(CompiledBackendMixin):
    """Whole-utterance transcription behind the micro-batch data plane:
    ``{"frames": [[float, ...], ...]}`` -> ``{"text": str, "frames":
    n}``. Utterances are zero-padded to their bucket and every batch to
    ``max_batch`` rows, one step callable per (max_batch, bucket); each
    row is sliced back to its length and greedy-decoded. The LSTM runs
    left to right, so a row's logits ignore its padded tail, and a
    request's result does not depend on its batchmates."""

    def __init__(self, cfg_name: str = "tiny", seed: int = 0,
                 max_batch: int = 8, device="cuda", params=None):
        self.model = build_speech_model(cfg_name, seed=seed, device=device,
                                        params=params)
        self.cfg = self.model.cfg
        self.device = self.model.device
        self.max_batch = max_batch
        self.alphabet = SERVE_ALPHABET[:self.cfg.n_classes - 1]
        self._fwd = self.model.logits_fn()
        self._tag = model_tag("speech_logits", self.cfg, seed)
        self._steps = CompileCache()

    @staticmethod
    def length_of(request: Dict[str, Any]) -> int:
        return len(request["frames"])

    def _compiled(self, pad_to: int):
        key = shape_key(self._tag,
                        (self.max_batch, pad_to, self.cfg.n_input),
                        "float32")
        return self._steps.get_or_build(key, lambda: self._fwd)

    def call(self, request: Dict[str, Any]) -> Any:
        return self.call_batch([request])[0]

    def logits_batch(self, requests, pad_to: Optional[int] = None):
        """(logits [max_batch, pad_to, classes] on the host, lengths) of
        one padded batch."""
        from tosem_tpu_torch.models.speech import pad_feats_batch
        if len(requests) > self.max_batch:
            raise ValueError(f"batch of {len(requests)} exceeds "
                             f"max_batch={self.max_batch}")
        frames = [np.asarray(r["frames"], np.float32) for r in requests]
        if pad_to is None:
            pad_to = max(f.shape[0] for f in frames)
        feats, lengths = pad_feats_batch(frames, pad_to,
                                         pad_batch_to=self.max_batch)
        logits = self._compiled(pad_to)(
            torch.from_numpy(feats).to(self.device))
        return _host(logits), lengths

    def call_batch(self, requests, pad_to: Optional[int] = None):
        logits, lengths = self.logits_batch(requests, pad_to)
        out = []
        for i in range(len(requests)):
            n = int(lengths[i])
            out.append({"text": greedy_ctc_text(logits[i, :n], self.alphabet,
                                                self.cfg.blank),
                        "frames": n})
        return out


class _SpeechDecodeSeq:
    """Replica-side record of one streaming utterance: its carry and
    frame buffer (tensors on the device), the remaining input in chunks,
    the emitted logits rows and ``outcomes[k]``, step ``k``'s memoized
    result (the idempotency ledger)."""

    __slots__ = ("h", "c", "buf", "chunks", "rows", "n_frames",
                 "next_step", "done", "outcomes")

    def __init__(self, h, c, buf, chunks, n_frames: int):
        self.h = h
        self.c = c
        self.buf = buf
        self.chunks = chunks
        self.rows: list = []
        self.n_frames = n_frames
        self.next_step = 0
        self.done = not chunks
        self.outcomes: list = []


class SpeechDecodeBackend(CompiledBackendMixin):
    """Streaming CTC decode behind the iteration-level scheduler.

    Each scheduler step feeds every packed utterance its next
    ``chunk_frames`` frames through one step callable
    (:meth:`~tosem_tpu_torch.models.speech.SpeechModel.decode_step_fn`)
    with static ``(max_batch, chunk)`` shapes; retired utterances ride
    along as zero rows. Admission primes the context buffer with the
    full pass's left zero padding (``c`` zeros) and the first ``c`` real
    frames, so every window the streamed LSTM consumes is a window of the
    full pass, in the same order. No ``spill_seq``: the carry is a few KB
    an utterance."""

    def __init__(self, cfg_name: str = "tiny", seed: int = 0,
                 max_batch: int = 8, chunk_frames: int = 8,
                 max_frames: int = 512, device="cuda", params=None):
        self.model = build_speech_model(cfg_name, seed=seed, device=device,
                                        params=params)
        self.cfg = self.model.cfg
        self.device = self.model.device
        self.max_batch = max_batch
        self.chunk_frames = chunk_frames
        self.max_frames = max_frames
        self.alphabet = SERVE_ALPHABET[:self.cfg.n_classes - 1]
        self._step = self.model.decode_step_fn()
        self._seqs: Dict[Any, _SpeechDecodeSeq] = {}
        self._lock = threading.RLock()
        self._tag = model_tag("speech_decode", self.cfg, seed,
                              chunk=chunk_frames)
        self._steps = CompileCache()

    def _step_compiled(self):
        key = shape_key(self._tag + ";step",
                        (self.max_batch, self.chunk_frames, self.cfg.n_input),
                        "float32")
        return self._steps.get_or_build(key, lambda: self._step)

    def warmup(self, shapes: Sequence[Any]) -> Dict[str, Any]:
        del shapes                   # one step callable serves every chunk
        self._step_compiled()
        return {"warmed": 1, "cache": self._steps.stats()}

    # ------------------------------------------------------- decode client

    def admit(self, seq_id, request: Dict[str, Any]) -> Dict[str, Any]:
        c, cfg = self.cfg.n_context, self.cfg
        with self._lock:
            if seq_id in self._seqs:          # at-least-once replay
                seq = self._seqs[seq_id]
                return {"done": seq.done and seq.next_step == 0}
            frames = np.asarray(request["frames"], np.float32)
            if frames.ndim != 2 or frames.shape[1] != cfg.n_input:
                raise ValueError(f"frames must be [n, {cfg.n_input}], "
                                 f"got {frames.shape}")
            n = frames.shape[0]
            if n < 1:
                raise ValueError("empty frames sequence")
            if n > self.max_frames:
                raise ValueError(f"utterance of {n} frames exceeds "
                                 f"max_frames={self.max_frames}")
            # the full pass pads c zeros each side; stream the padded
            # sequence so every consumed window is a full-pass window
            zeros = np.zeros((c, cfg.n_input), np.float32)
            padded = np.concatenate([zeros, frames, zeros], axis=0)
            buf, rest = padded[:2 * c], padded[2 * c:]
            pad = -len(rest) % self.chunk_frames
            if pad:
                rest = np.concatenate(
                    [rest, np.zeros((pad, cfg.n_input), np.float32)])
            chunks = [rest[i:i + self.chunk_frames]
                      for i in range(0, len(rest), self.chunk_frames)]
            h = torch.zeros((cfg.n_cell,), device=self.device)
            self._seqs[seq_id] = _SpeechDecodeSeq(
                h=h, c=h.clone(), buf=torch.from_numpy(buf).to(self.device),
                chunks=chunks, n_frames=n)
            return {"done": self._seqs[seq_id].done}

    def step_batch(self, seq_ids: List[Any],
                   step_idxs: List[int]) -> List[Dict[str, Any]]:
        """One scheduler iteration: each live utterance's next chunk
        through the shared static-shape step."""
        if len(seq_ids) > self.max_batch:
            raise ValueError(f"batch of {len(seq_ids)} exceeds "
                             f"max_batch={self.max_batch}")
        cfg, B, dev = self.cfg, self.max_batch, self.device
        with self._lock:
            h = torch.zeros((B, cfg.n_cell), device=dev)
            ch = torch.zeros((B, cfg.n_cell), device=dev)
            buf = torch.zeros((B, 2 * cfg.n_context, cfg.n_input),
                              device=dev)
            chunk = np.zeros((B, self.chunk_frames, cfg.n_input),
                             np.float32)
            outcomes: List[Optional[Dict[str, Any]]] = []
            live: List[Tuple[int, Any, _SpeechDecodeSeq]] = []
            for row, (sid, step) in enumerate(zip(seq_ids, step_idxs)):
                seq = self._seqs[sid]
                if step < seq.next_step:      # replayed step: memo only
                    outcomes.append(seq.outcomes[step])
                    continue
                if step > seq.next_step:
                    raise RuntimeError(
                        f"step {step} for {sid!r} skips ahead of "
                        f"{seq.next_step} (scheduler bug)")
                if seq.done:
                    outcomes.append({"done": True})
                    continue
                h[row], ch[row], buf[row] = seq.h, seq.c, seq.buf
                chunk[row] = seq.chunks[seq.next_step]
                outcomes.append(None)
                live.append((row, sid, seq))
            if live:
                logits, h2, c2, buf2 = self._step_compiled()(
                    h, ch, buf, torch.from_numpy(chunk).to(dev))
                for row, sid, seq in live:
                    seq.h, seq.c = h2[row].clone(), c2[row].clone()
                    seq.buf = buf2[row].clone()
                    seq.rows.append(logits[row])
                    seq.next_step += 1
                    out = {"done": seq.next_step >= len(seq.chunks),
                           "frames": self.chunk_frames}
                    seq.done = out["done"]
                    if seq.done:
                        # the final payload rides the outcome: no extra
                        # round trip to retire
                        out["result"] = self._result_locked(seq)
                    seq.outcomes.append(out)
                    outcomes[row] = out
            return outcomes

    def logits_rows(self, seq_id) -> np.ndarray:
        """The logits rows emitted so far for ``seq_id``, cut to its
        frames (host copy)."""
        with self._lock:
            return self._rows_locked(self._seqs[seq_id])

    def _rows_locked(self, seq: _SpeechDecodeSeq) -> np.ndarray:
        if not seq.rows:
            return np.zeros((0, self.cfg.n_classes), np.float32)
        return _host(torch.cat(seq.rows))[:seq.n_frames]

    def _result_locked(self, seq: _SpeechDecodeSeq) -> Dict[str, Any]:
        text = greedy_ctc_text(self._rows_locked(seq), self.alphabet,
                               self.cfg.blank)
        return {"text": text, "frames": seq.n_frames}

    def result(self, seq_id) -> Dict[str, Any]:
        with self._lock:
            return self._result_locked(self._seqs[seq_id])

    def release(self, seq_id) -> None:
        with self._lock:
            self._seqs.pop(seq_id, None)

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        with self._lock:
            out["decode_sequences"] = len(self._seqs)
        return out


class StreamingClient:
    """Client-side stream with replay recovery (broken-stream retry).

    Pins a session to whichever replica answers; if that replica dies
    mid-stream, the client re-creates the session and replays every
    acknowledged chunk: the stream survives replica loss at the cost of
    recomputation."""

    def __init__(self, handle, session: str):
        self.handle = handle
        self.session = session
        self._fed: list = []
        self._call({"op": "create", "session": session})

    def _call(self, req, retried: bool = False):
        try:
            return self.handle.call(req, timeout=60.0)
        except Exception:
            if retried:
                raise
            # replica lost: a fresh session, every ACKNOWLEDGED chunk
            # replayed (the request in flight is not in _fed yet, so
            # replay-then-retry applies it exactly once)
            self.handle.call({"op": "create", "session": self.session},
                             timeout=60.0)
            for frames in self._fed:
                self.handle.call({"op": "feed", "session": self.session,
                                  "frames": frames}, timeout=60.0)
            if req["op"] == "create":
                return {"ok": True}
            return self._call(req, retried=True)

    def feed(self, frames) -> None:
        frames = np.asarray(frames, np.float32).tolist()
        self._call({"op": "feed", "session": self.session,
                    "frames": frames})
        self._fed.append(frames)   # buffered only after the ack

    def intermediate(self) -> str:
        return self._call({"op": "intermediate",
                           "session": self.session})["text"]

    def finish(self) -> str:
        return self._call({"op": "finish", "session": self.session})["text"]
