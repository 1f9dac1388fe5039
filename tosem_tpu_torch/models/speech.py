"""Streaming speech-to-text model (the DeepSpeech-family member).

Counterpart of ``tosem_tpu/models/speech.py``, the reference's acoustic
model (``train.py:163`` ``create_model``): per-frame context windows
over MFCC features -> three clipped-ReLU dense layers with dropout -> a
unidirectional LSTM -> dense -> CTC logits (vocab + blank). The LSTM is
the JAX package's cell (gates ``i, f, g, o`` in that order, forget bias
1.0 at init, uniform init at ``1/sqrt(in)`` and ``1/sqrt(cell)``) run as
a loop over time whose carry is the streaming state; ``nn.LSTM``/cuDNN
lays out its gates and biases its own way and is not used. The input
projection of every frame is one product ahead of the loop, the
recurrent one a product a step. Every product is fp32 with TF32 off.

Streaming: :meth:`SpeechModel.streaming_init` / :meth:`streaming_step`
hold (LSTM carry, frame buffer) like the native client's
``StreamingState``; the buffer starts as the ``c`` zero frames of left
context, so the streamed LSTM sees the full pass's windows in the same
order. Serving entry points (:meth:`logits_fn`, :meth:`decode_step_fn`)
run under ``torch.no_grad()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch
from torch import nn

from tosem_tpu_torch.nn.layers import Dense, Dropout
from tosem_tpu_torch.ops.common import precision, resolve_device


@dataclass
class SpeechConfig:
    n_input: int = 26          # MFCC coefficients per frame
    n_context: int = 9         # frames of context each side (window = 19)
    n_hidden: int = 2048       # dense width (reference n_hidden)
    n_cell: int = 2048         # LSTM cells
    vocab_size: int = 28       # a-z, space, apostrophe (reference alphabet)
    relu_clip: float = 20.0    # train.py clipped_relu bound
    dropout: float = 0.05

    @classmethod
    def tiny(cls) -> "SpeechConfig":
        return cls(n_input=13, n_context=2, n_hidden=64, n_cell=64,
                   vocab_size=12)

    @property
    def blank(self) -> int:
        return self.vocab_size  # CTC blank appended after the alphabet

    @property
    def n_classes(self) -> int:
        return self.vocab_size + 1

    @property
    def window(self) -> int:
        return 2 * self.n_context + 1


def context_windows(x: torch.Tensor, n_context: int) -> torch.Tensor:
    """[B, T, F] -> [B, T, (2c+1)*F] overlapping windows, zero-padded
    edges (a gather, as the JAX package does it)."""
    B, T, F = x.shape
    c = n_context
    padded = torch.nn.functional.pad(x, (0, 0, c, c))
    idx = (torch.arange(T, device=x.device)[:, None]
           + torch.arange(2 * c + 1, device=x.device)[None, :])  # [T, W]
    return padded[:, idx, :].reshape(B, T, (2 * c + 1) * F)


class LSTM(nn.Module):
    """Unidirectional LSTM: ``wi`` [in, 4·cell], ``wh`` [cell, 4·cell],
    ``b`` [4·cell], gates ``i, f, g, o``."""

    def __init__(self, in_dim: int, n_cell: int, *, generator=None):
        super().__init__()
        self.in_dim, self.n_cell = in_dim, n_cell
        s_i = 1.0 / math.sqrt(in_dim)
        s_h = 1.0 / math.sqrt(n_cell)

        def uniform(shape, scale):
            return torch.rand(shape, generator=generator) * (2 * scale) \
                - scale
        self.wi = nn.Parameter(uniform((in_dim, 4 * n_cell), s_i))
        self.wh = nn.Parameter(uniform((n_cell, 4 * n_cell), s_h))
        b = torch.zeros(4 * n_cell)
        b[n_cell:2 * n_cell] = 1.0      # forget-gate bias
        self.b = nn.Parameter(b)

    def initial_carry(self, batch: int, device=None):
        z = torch.zeros((batch, self.n_cell), device=device)
        return z, z.clone()

    def forward(self, x, *, carry=None):
        """x: [B, T, in] -> ([B, T, cell], final (h, c))."""
        B, T, _ = x.shape
        h, c = carry if carry is not None else \
            self.initial_carry(B, x.device)
        with precision("float32"):
            xw = torch.matmul(x, self.wi)                  # [B, T, 4·cell]
            hs = []
            for t in range(T):
                z = xw[:, t] + torch.matmul(h, self.wh) + self.b
                i, f, g, o = z.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
        out = torch.stack(hs, 1) if hs else x.new_zeros((B, 0, self.n_cell))
        return out, (h, c)


class SpeechModel(nn.Module):
    """``create_model`` as a module: ``SpeechModel(cfg, device="cuda",
    seed=0)``; tests pass ``device="cpu"``."""

    def __init__(self, cfg: SpeechConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        gen = torch.Generator().manual_seed(int(seed))
        kw = dict(precision="float32", generator=gen)
        self.d1 = Dense(c.window * c.n_input, c.n_hidden, **kw)
        self.d2 = Dense(c.n_hidden, c.n_hidden, **kw)
        self.d3 = Dense(c.n_hidden, c.n_hidden, **kw)
        self.lstm = LSTM(c.n_hidden, c.n_cell, generator=gen)
        self.d5 = Dense(c.n_cell, c.n_hidden, **kw)
        self.out = Dense(c.n_hidden, c.n_classes, **kw)
        self.drop = Dropout(c.dropout)
        self.to(dev)
        self.device = dev

    def _clip_relu(self, x):
        return torch.clamp(torch.relu(x), max=self.cfg.relu_clip)

    def _dense_stack(self, x, train, generator):
        for d in (self.d1, self.d2, self.d3):
            x = self.drop(self._clip_relu(d(x)), train=train,
                          generator=generator)
        return x

    def _head(self, x):
        return self.out(self._clip_relu(self.d5(x)))

    def forward(self, feats, *, carry=None, train=False, generator=None):
        """feats: [B, T, n_input] MFCC -> (logits [B, T, n_classes],
        carry). ``generator`` drives dropout when ``train``."""
        x = context_windows(feats.float(), self.cfg.n_context)
        x = self._dense_stack(x, train, generator)
        x, carry = self.lstm(x, carry=carry)
        return self._head(x), carry

    # ------------------------------------------------------------ streaming

    def streaming_init(self, batch: int = 1) -> Tuple[Any, torch.Tensor]:
        """(LSTM carry, frame buffer); the buffer starts as the c zero
        frames of left context."""
        buf = torch.zeros((batch, self.cfg.n_context, self.cfg.n_input),
                          device=self.device)
        return self.lstm.initial_carry(batch, self.device), buf

    def streaming_step(self, state, chunk: torch.Tensor):
        """Feed frames [B, n, n_input]; emit logits for every frame whose
        full +-c context is now known (output lags input by c frames;
        :meth:`streaming_flush` emits the tail)."""
        carry, buf = state
        c = self.cfg.n_context
        seq = torch.cat([buf, chunk.float().to(buf.device)], 1)
        k = seq.shape[1] - 2 * c          # centers with full context
        if k <= 0:
            return (seq.new_zeros((chunk.shape[0], 0, self.cfg.n_classes)),
                    (carry, seq))
        idx = (torch.arange(k, device=seq.device)[:, None]
               + torch.arange(2 * c + 1, device=seq.device)[None, :])
        win = seq[:, idx, :].reshape(seq.shape[0], k, -1)
        x = self._dense_stack(win, False, None)
        x, carry = self.lstm(x, carry=carry)
        return self._head(x), (carry, seq[:, k:, :])

    def streaming_flush(self, state):
        """End of stream: feed c zero frames (the full pass's right
        padding) to emit the last c logits."""
        batch = state[1].shape[0]
        zeros = torch.zeros((batch, self.cfg.n_context, self.cfg.n_input),
                            device=state[1].device)
        return self.streaming_step(state, zeros)

    def decode_step_fn(self):
        """``step(h, c, buf, chunk) -> (logits, h, c, buf)`` with static
        shapes (``h``/``c`` [B, n_cell], ``buf`` [B, 2·n_context,
        n_input], ``chunk`` [B, chunk_frames, n_input]): the serving
        scheduler's decode step, the LSTM carry its cache."""
        @torch.no_grad()
        def step(h, c, buf, chunk):
            logits, ((h2, c2), buf2) = self.streaming_step(((h, c), buf),
                                                           chunk)
            return logits, h2, c2, buf2
        return step

    def logits_fn(self):
        """``fwd(feats) -> logits``: the batched-inference entry point.
        The LSTM runs left to right, so a row's logits before its true
        length are untouched by its zero-padded tail."""
        @torch.no_grad()
        def fwd(feats):
            return self(feats)[0]
        return fwd


def pad_feats_batch(feats_list, pad_to: int, pad_batch_to: int = 0):
    """Variable-length [T_i, F] feature sequences -> one zero-padded
    [B, pad_to, F] batch plus true lengths (numpy); ``pad_batch_to`` pads
    the batch too (filler rows are zero, of length 0)."""
    import numpy as np
    B = len(feats_list)
    BP = max(B, pad_batch_to)
    F = np.asarray(feats_list[0]).shape[-1]
    feats = np.zeros((BP, pad_to, F), np.float32)
    lengths = np.zeros((BP,), np.int32)
    for i, f in enumerate(feats_list):
        f = np.asarray(f, np.float32)
        if f.shape[0] > pad_to:
            raise ValueError(f"sequence {i} length {f.shape[0]} exceeds "
                             f"pad target {pad_to}")
        feats[i, :f.shape[0]] = f
        lengths[i] = f.shape[0]
    return feats, lengths


# --------------------------------------------------------------- metrics

def edit_distance(a, b) -> int:
    """Levenshtein distance (host-side, for WER/CER eval)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def wer(ref: str, hyp: str) -> float:
    """Word error rate (evaluate.py / util/evaluate_tools.py role)."""
    rw = ref.split()
    return edit_distance(rw, hyp.split()) / max(1, len(rw))


def cer(ref: str, hyp: str) -> float:
    return edit_distance(list(ref), list(hyp)) / max(1, len(ref))


def transcribe(log_probs, blank: int, beam_width: int = 32,
               scorer=None, bonus=None) -> str:
    """Decode one utterance to text by beam search, with the external
    scorer when given (the reference's LM-rescored eval path)."""
    from tosem_tpu_torch.data.audio import labels_to_text
    from tosem_tpu_torch.ops.ctc import beam_search_decode
    labels, _ = beam_search_decode(log_probs, blank=blank,
                                   beam_width=beam_width, bonus=bonus,
                                   scorer=scorer)
    return labels_to_text(labels)


def evaluate_wer(batch_log_probs, lengths, refs, blank: int,
                 beam_width: int = 32, scorer=None) -> dict:
    """Mean WER/CER over a batch. ``batch_log_probs``: [B, T, V]
    log-softmax (numpy or a tensor); ``lengths``: [B]."""
    import numpy as np
    if torch.is_tensor(batch_log_probs):
        batch_log_probs = batch_log_probs.detach().float().cpu().numpy()
    if torch.is_tensor(lengths):
        lengths = lengths.cpu().numpy()
    lp = np.asarray(batch_log_probs)
    ln = np.asarray(lengths)
    wers, cers, hyps = [], [], []
    for i, ref in enumerate(refs):
        hyp = transcribe(lp[i, :int(ln[i])], blank=blank,
                         beam_width=beam_width, scorer=scorer)
        hyps.append(hyp)
        wers.append(wer(ref, hyp))
        cers.append(cer(ref, hyp))
    return {"wer": float(np.mean(wers)), "cer": float(np.mean(cers)),
            "hypotheses": hyps}
