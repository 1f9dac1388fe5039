"""Audio feature pipeline: MFCC extraction and augmentation.

Counterpart of ``tosem_tpu/data/audio.py`` (the reference's
``samples_to_mfccs`` and ``util/augmentations.py`` roles). The
featurizer runs on the tensors' device: pre-emphasis, framing as a
strided gather, a Hamming window (numpy's, in fp32), ``torch.fft.rfft``,
the power spectrum through a mel filterbank and a DCT-II, both matrices
built on the host with numpy exactly as the JAX package builds them.
:func:`spec_augment` draws its masks from an explicit
``torch.Generator``: the draws are not the JAX package's, the masks'
shape and coverage are. Torch is imported inside the tensor functions:
the alphabet helpers load without it, as the serving control plane's
modules, which import ``data.feeding``, must.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_filters: int, n_fft: int, sample_rate: int,
                   f_min: float = 20.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """[n_fft//2+1, n_filters] triangular mel filter matrix."""
    f_max = f_max or sample_rate / 2.0
    mels = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_filters + 2)
    hz = _mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sample_rate).astype(int)
    fb = np.zeros((n_fft // 2 + 1, n_filters), dtype=np.float32)
    for i in range(n_filters):
        lo, mid, hi = bins[i], bins[i + 1], bins[i + 2]
        for j in range(lo, mid):
            if mid > lo:
                fb[j, i] = (j - lo) / (mid - lo)
        for j in range(mid, hi):
            if hi > mid:
                fb[j, i] = (hi - j) / (hi - mid)
    return fb


@functools.lru_cache(maxsize=8)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_in, n_out]."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    m *= np.sqrt(2.0 / n_in)
    m[:, 0] *= np.sqrt(0.5)
    return m.astype(np.float32)


def frame_signal(audio, frame_length: int, frame_step: int):
    """[B, N] -> [B, T, frame_length] overlapping frames."""
    import torch
    n = audio.shape[-1]
    T = max(1 + (n - frame_length) // frame_step, 0)
    idx = (torch.arange(T, device=audio.device)[:, None] * frame_step
           + torch.arange(frame_length, device=audio.device)[None, :])
    return audio[..., idx]


def mfcc(audio, *, sample_rate: int = 16000, n_mfcc: int = 26,
         n_filters: int = 40, frame_length_ms: float = 25.0,
         frame_step_ms: float = 10.0, pre_emphasis: float = 0.97):
    """[B, N] PCM tensor -> [B, T, n_mfcc] MFCC features (fp32, TF32
    off), on ``audio``'s device."""
    import torch

    from tosem_tpu_torch.ops.common import precision
    audio = audio.float()
    dev = audio.device
    fl = int(sample_rate * frame_length_ms / 1000)
    fs = int(sample_rate * frame_step_ms / 1000)
    n_fft = int(2 ** np.ceil(np.log2(fl)))
    emphasized = torch.cat(
        [audio[..., :1], audio[..., 1:] - pre_emphasis * audio[..., :-1]],
        dim=-1)
    frames = frame_signal(emphasized, fl, fs)                # [B, T, fl]
    window = torch.from_numpy(np.hamming(fl).astype(np.float32)).to(dev)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = (spec.abs() ** 2) / n_fft                        # [B, T, F]
    fb = torch.from_numpy(mel_filterbank(n_filters, n_fft,
                                         sample_rate)).to(dev)
    dct = torch.from_numpy(dct_matrix(n_mfcc, n_filters)).to(dev)
    with precision("float32"):
        mel = torch.log(power @ fb + 1e-8)                   # [B, T, M]
        return mel @ dct                                     # [B, T, C]


def spec_augment(feats, generator, *, time_masks: int = 2,
                 time_width: int = 10, freq_masks: int = 2,
                 freq_width: int = 4):
    """SpecAugment-style time and frequency masking: each row gets
    ``time_masks`` bands of ``time_width`` frames and ``freq_masks``
    bands of ``freq_width`` coefficients zeroed, their starts drawn from
    ``generator`` (a ``torch.Generator`` on ``feats``' device) as the JAX
    package draws them, uniform in [0, max(len - width, 1))."""
    import torch
    B, T, F = feats.shape
    dev = feats.device

    def mask_axis(x, n_masks, width, axis_len, axis):
        starts = torch.randint(0, max(axis_len - width, 1), (B, n_masks),
                               generator=generator, device=dev)
        pos = torch.arange(axis_len, device=dev)
        cover = ((pos[None, None, :] >= starts[..., None])
                 & (pos[None, None, :] < starts[..., None] + width)).any(1)
        shape = [B, 1, 1]
        shape[axis] = axis_len
        return x * (~cover).to(x.dtype).reshape(shape)

    feats = mask_axis(feats, time_masks, time_width, T, 1)
    return mask_axis(feats, freq_masks, freq_width, F, 2)


ALPHABET = "abcdefghijklmnopqrstuvwxyz '"


def text_to_labels(text: str, alphabet: str = ALPHABET) -> list:
    return [alphabet.index(ch) for ch in text.lower() if ch in alphabet]


def labels_to_text(labels, alphabet: str = ALPHABET) -> str:
    return "".join(alphabet[i] for i in labels if 0 <= i < len(alphabet))
