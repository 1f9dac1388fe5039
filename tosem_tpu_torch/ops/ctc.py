"""CTC loss (log-space forward algorithm), greedy and beam decoding.

Counterpart of ``tosem_tpu/ops/ctc.py`` (the role of DeepSpeech's
``tfv1.nn.ctc_loss`` and ``native_client/ctcdecode/``). :func:`ctc_loss`
is the JAX package's alpha recursion, its ``lax.scan`` become a loop over
time on the logits' device: fp32 log-probabilities, the extended label
sequence with its skip rule, masking by each row's input length, and
``-1e30`` as log zero, combined by the same ``_logaddexp``. Its gradient
is autograd's through the loop. No kernel of a library computes it on
the path (``F.ctc_loss`` is a yardstick only).

:func:`beam_search_decode` and :class:`Scorer` reach the native prefix
beam decoder (``tosem_tpu_torch/native/ctc_decoder.cpp``, built with g++
on first use) through ctypes; the log-probabilities reach it as host
numpy arrays.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

_NEG = -1e30


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-(a - b).abs()))


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-example negative log likelihood, shape [B].

    logits: [B, T, V] unnormalized; labels: [B, L] int (padded, values
    != blank in the first ``label_lengths`` positions); input_lengths:
    [B]; label_lengths: [B]."""
    B, T, V = logits.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logits.device
    labels = labels.long().to(dev)
    input_lengths = input_lengths.long().to(dev)
    label_lengths = label_lengths.long().to(dev)
    logp = torch.log_softmax(logits.float(), dim=-1)

    # extended label sequence: blank, l1, blank, l2, ... blank -> [B, S]
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    # alpha[s] can come from s-2 iff ext[s] != blank and ext[s] != ext[s-2]
    ext_shift2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                       device=dev), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != ext_shift2)

    s_idx = torch.arange(S, device=dev)[None, :]
    zero = torch.zeros((), device=dev)
    neg = torch.full((), _NEG, device=dev)
    init = torch.where(s_idx == 0, zero,
                       torch.where((s_idx == 1)
                                   & (label_lengths[:, None] > 0), zero, neg))
    emit = logp.gather(2, ext[:, None, :].expand(B, T, S))    # [B, T, S]
    alpha = init + emit[:, 0]
    pad1 = torch.full((B, 1), _NEG, device=dev)
    pad2 = torch.full((B, 2), _NEG, device=dev)
    live = torch.arange(T, device=dev)[None, :] < input_lengths[:, None]
    for t in range(1, T):
        prev1 = torch.cat([pad1, alpha[:, :-1]], 1)
        prev2 = torch.cat([pad2, alpha[:, :-2]], 1)
        a = _logaddexp(alpha, prev1)
        a = torch.where(can_skip, _logaddexp(a, prev2), a)
        # frozen past input_length: the final read sees the last live alpha
        alpha = torch.where(live[:, t, None], a + emit[:, t], alpha)

    last = 2 * label_lengths                                  # [B]
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = torch.where(
        label_lengths > 0,
        alpha.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0], neg)
    return -_logaddexp(a_last, a_prev)


def ctc_loss_mean(logits, labels, input_lengths, label_lengths,
                  blank: int = 0) -> torch.Tensor:
    """Batch-mean CTC loss (the training objective)."""
    return ctc_loss(logits, labels, input_lengths, label_lengths,
                    blank).mean()


@functools.lru_cache(maxsize=None)
def _decoder_lib():
    from tosem_tpu_torch.native import load_library

    lib = load_library("ctc_decoder")
    i32, f32, ptr = ctypes.c_int32, ctypes.c_float, ctypes.c_void_p
    out_args = [ptr, ctypes.POINTER(i32), ctypes.POINTER(f32), i32]
    lib.ctc_beam_decode.restype = ctypes.c_int
    lib.ctc_beam_decode.argtypes = [ptr, i32, i32, i32, i32, ptr] + out_args
    lib.ctc_beam_decode_lm.restype = ctypes.c_int
    lib.ctc_beam_decode_lm.argtypes = ([ptr, i32, i32, i32, i32, ptr,
                                        f32, f32, i32, ptr] + out_args)
    lib.tosem_lm_load.restype = ctypes.c_void_p
    lib.tosem_lm_load.argtypes = [ctypes.c_char_p]
    lib.tosem_lm_free.argtypes = [ctypes.c_void_p]
    lib.tosem_lm_order.restype = ctypes.c_int32
    lib.tosem_lm_order.argtypes = [ctypes.c_void_p]
    lib.tosem_lm_n_words.restype = ctypes.c_int32
    lib.tosem_lm_n_words.argtypes = [ctypes.c_void_p]
    lib.tosem_lm_score.restype = ctypes.c_float
    lib.tosem_lm_score.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int32, ctypes.c_int32]
    lib.tosem_lm_word_id.restype = ctypes.c_int32
    lib.tosem_lm_word_id.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int32]
    return lib


class Scorer:
    """Loaded n-gram LM with alpha/beta weights (the KenLM ``Scorer``
    analog; packages come from
    :func:`tosem_tpu_torch.data.scorer.build_scorer`)."""

    def __init__(self, path: str, alpha: float = 1.8, beta: float = 0.8,
                 space_index: Optional[int] = None):
        from tosem_tpu_torch.data.audio import ALPHABET
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.space_index = (ALPHABET.index(" ") if space_index is None
                            else int(space_index))
        self._lib = _decoder_lib()
        self._h = self._lib.tosem_lm_load(str(path).encode())
        if not self._h:
            raise FileNotFoundError(f"cannot load scorer package: {path}")

    def _handle(self):
        if not getattr(self, "_h", None):
            raise ValueError("Scorer is closed")
        return self._h

    @property
    def order(self) -> int:
        return int(self._lib.tosem_lm_order(self._handle()))

    @property
    def n_words(self) -> int:
        return int(self._lib.tosem_lm_n_words(self._handle()))

    def word_id(self, word: str, alphabet: str = None) -> int:
        """Label-trie lookup; -1 = OOV."""
        from tosem_tpu_torch.data.audio import ALPHABET, text_to_labels
        labels = np.asarray(
            text_to_labels(word, alphabet or ALPHABET), np.int32)
        return int(self._lib.tosem_lm_word_id(
            self._handle(), labels.ctypes.data_as(ctypes.c_void_p),
            len(labels)))

    def score(self, context_ids, word_id: int) -> float:
        """Raw ``logP(word | context)`` (unweighted)."""
        ctx = np.asarray(list(context_ids), np.int32)
        return float(self._lib.tosem_lm_score(
            self._handle(), ctx.ctypes.data_as(ctypes.c_void_p), len(ctx),
            int(word_id)))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tosem_lm_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def beam_search_decode(log_probs, blank: int, beam_width: int = 32,
                       bonus=None,
                       scorer: Optional[Scorer] = None) -> Tuple[list, float]:
    """Prefix beam search through the native decoder.

    log_probs: [T, V] log-softmax scores (numpy, or a tensor on any
    device: it is copied to the host). bonus: optional [V] per-symbol
    additive score (hot-word biasing). scorer: optional :class:`Scorer`,
    word-boundary LM rescoring with its alpha/beta weights.
    Returns (labels, log_score)."""
    lib = _decoder_lib()
    if torch.is_tensor(log_probs):
        log_probs = log_probs.detach().float().cpu().numpy()
    lp = np.ascontiguousarray(np.asarray(log_probs), dtype=np.float32)
    T, V = lp.shape
    out = np.zeros(max(T, 1), dtype=np.int32)
    out_len = ctypes.c_int32()
    out_score = ctypes.c_float()
    b = (np.ascontiguousarray(np.asarray(bonus), dtype=np.float32)
         if bonus is not None else None)
    b_ptr = b.ctypes.data_as(ctypes.c_void_p) if b is not None else None
    common = (lp.ctypes.data_as(ctypes.c_void_p), T, V, blank, beam_width)
    outs = (out.ctypes.data_as(ctypes.c_void_p), ctypes.byref(out_len),
            ctypes.byref(out_score), T)
    if scorer is None:
        rc = lib.ctc_beam_decode(*common, b_ptr, *outs)
    else:
        rc = lib.ctc_beam_decode_lm(
            *common, ctypes.c_void_p(scorer._handle()),
            ctypes.c_float(scorer.alpha), ctypes.c_float(scorer.beta),
            scorer.space_index, b_ptr, *outs)
    if rc != 0:
        raise RuntimeError("ctc_beam_decode failed")
    return out[:out_len.value].tolist(), float(out_score.value)


def greedy_decode(logits: torch.Tensor, input_lengths: Optional[torch.Tensor],
                  blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode: argmax per frame, collapse repeats, drop blanks.
    Returns (labels [B, T] padded with ``blank``, lengths [B])."""
    B, T, V = logits.shape
    best = logits.argmax(-1)                                  # [B, T]
    prev = torch.cat([torch.full((B, 1), -1, dtype=best.dtype,
                                 device=best.device), best[:, :-1]], 1)
    keep = (best != blank) & (best != prev)
    if input_lengths is not None:
        keep &= (torch.arange(T, device=best.device)[None, :]
                 < input_lengths.to(best.device)[:, None])
    pos = torch.cumsum(keep.long(), 1) - 1
    out = torch.full((B, T), blank, dtype=best.dtype, device=best.device)
    b_idx, t_idx = keep.nonzero(as_tuple=True)
    out[b_idx, pos[b_idx, t_idx]] = best[b_idx, t_idx]
    return out, keep.sum(1)
