"""Dataset layer: importers, sample collections, length-bucketed batching.

Counterpart of ``tosem_tpu/data/feeding.py`` (the reference's DeepSpeech
feeding stack, ``util/feeding.py`` and ``bin/import_*.py``): CSV
manifests of lazy WAV samples, the synthetic corpus importer (its numpy
draws bit for bit the JAX package's), the padding-bucket rules the
serving layer shares (:func:`bucket_boundaries`, :func:`bucket_for`,
:func:`sparse_mask_spec`, :func:`pad_target`) and the bucketed speech
batcher, whose MFCC front end (:func:`tosem_tpu_torch.data.audio.mfcc`)
runs on the ``device`` it is given.
"""
from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from tosem_tpu_torch.data.audio import ALPHABET, text_to_labels


@dataclass
class Sample:
    """One utterance: lazily-loaded audio + transcript."""
    audio_path: str
    size_bytes: int
    transcript: str
    duration_s: Optional[float] = None

    def load_audio(self) -> np.ndarray:
        """Reads 16-bit PCM WAV (the corpus format) or .npy feature files."""
        if self.audio_path.endswith(".npy"):
            return np.load(self.audio_path)
        import wave
        with wave.open(self.audio_path, "rb") as w:
            raw = w.readframes(w.getnframes())
        return (np.frombuffer(raw, np.int16).astype(np.float32)
                / 32768.0)


class SampleCollection:
    """An ordered set of samples (sample_collections.py role)."""

    def __init__(self, samples: Sequence[Sample]):
        self.samples = list(samples)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i) -> Sample:
        return self.samples[i]

    def __iter__(self) -> Iterator[Sample]:
        return iter(self.samples)

    def sorted_by_size(self) -> "SampleCollection":
        """Ascending by payload size (the reference trains smallest
        first)."""
        return SampleCollection(sorted(self.samples,
                                       key=lambda s: s.size_bytes))


CSV_FIELDS = ("wav_filename", "wav_filesize", "transcript")


def write_csv_manifest(path: str, samples: Sequence[Sample]) -> None:
    """The ``import_*.py`` output contract: a 3-column CSV manifest."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_FIELDS)
        for s in samples:
            w.writerow([s.audio_path, s.size_bytes, s.transcript])


def read_csv_manifest(path: str) -> SampleCollection:
    """Load a manifest CSV (util/feeding.py create_dataset input)."""
    out: List[Sample] = []
    base = os.path.dirname(os.path.abspath(path))
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            p = row["wav_filename"]
            if not os.path.isabs(p):
                p = os.path.join(base, p)
            out.append(Sample(p, int(row["wav_filesize"]),
                              row["transcript"]))
    return SampleCollection(out)


def import_synthetic_corpus(root: str, n: int = 32, *, seed: int = 0,
                            sample_rate: int = 16000,
                            min_s: float = 0.3, max_s: float = 1.2,
                            alphabet: str = ALPHABET) -> str:
    """An ``bin/import_*.py`` analog that fabricates a small WAV corpus
    (random speech-band noise + random transcripts, the JAX package's
    numpy draws in its order) and writes the manifest -> manifest path."""
    import wave
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    letters = alphabet.replace("'", "")[:26]
    samples: List[Sample] = []
    for i in range(n):
        dur = float(rng.uniform(min_s, max_s))
        t = np.arange(int(dur * sample_rate)) / sample_rate
        f0 = rng.uniform(80, 300)
        sig = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.1 * rng.normal(size=t.shape))
        pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int16)
        path = os.path.join(root, f"utt{i:04d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.tobytes())
        n_words = int(rng.integers(1, 4))
        words = ["".join(rng.choice(list(letters),
                                    size=int(rng.integers(2, 6))))
                 for _ in range(n_words)]
        samples.append(Sample(path, os.path.getsize(path), " ".join(words),
                              duration_s=dur))
    manifest = os.path.join(root, "manifest.csv")
    write_csv_manifest(manifest, samples)
    return manifest


# ------------------------------------------------------------- bucketing

@dataclass
class Batch:
    """Padded fixed-shape batch: features [B, T, F], labels [B, L]."""
    features: np.ndarray
    feature_lengths: np.ndarray
    labels: np.ndarray
    label_lengths: np.ndarray


def bucket_boundaries(lengths: Sequence[int], n_buckets: int) -> List[int]:
    """Quantile pad-target palette: one step callable per bucket."""
    qs = np.quantile(np.asarray(lengths, float),
                     np.linspace(0, 1, n_buckets + 1)[1:])
    out: List[int] = []
    for q in qs:
        b = int(math.ceil(q))
        if not out or b > out[-1]:
            out.append(b)
    return out


def bucket_for(length: int, boundaries: Sequence[int]) -> Optional[int]:
    """Smallest palette bucket that fits ``length``, or None when it
    exceeds the largest bucket: the one routing rule the training
    batcher and the serving bucket router share."""
    for b in boundaries:
        if length <= b:
            return b
    return None


def sparse_mask_spec(pad_t: int, *, local_window: Optional[int] = None,
                     doc_len: Optional[int] = None) -> Optional[str]:
    """Which block-sparse mask spec a batch padded to ``pad_t`` should
    ride, or None for the dense path.

    A sliding window pays only once the bucket spans more than twice the
    window (below that the band covers every block), and document
    packing only once a row holds more than one document. Windowed
    buckets get the symmetric encoder band ``local:W:W-1`` (W keys of
    left context incl. self, W-1 right); doc-packed buckets get the
    block-diagonal ``doc:L``. Both compose, documents first, and either
    way the request's key-padding mask still applies as segment ids."""
    specs = []
    if doc_len is not None and doc_len >= 1 and pad_t > doc_len:
        specs.append(f"doc:{doc_len}")
    if local_window is not None and local_window >= 1 \
            and pad_t > 2 * local_window:
        specs.append(f"local:{local_window}:{local_window - 1}")
    return "+".join(specs) if specs else None


def pad_target(length: int, boundaries: Sequence[int],
               align: int = 1) -> int:
    """Pad target for a sequence at serving time: its palette bucket
    when one fits, else ``length`` rounded up to ``align`` (overlong
    requests can't be dropped the way the training batcher drops them —
    they get their own aligned shape, keeping e.g. flash-attention tile
    eligibility where possible)."""
    b = bucket_for(length, boundaries)
    if b is not None:
        return b
    return int(math.ceil(length / align) * align) if align > 1 else length


class BucketedBatcher:
    """Length-bucketed, padded batching (feeding.py batch_fn role).

    Groups featurized samples into per-bucket bins; a bin flushes as a
    fixed-shape :class:`Batch` when full. ``drain()`` flushes partials
    (padding the batch dim too, so shapes stay in the palette).
    """

    def __init__(self, batch_size: int, boundaries: Sequence[int],
                 max_label_len: int):
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.max_label_len = max_label_len
        self._bins: Dict[int, List] = {b: [] for b in self.boundaries}
        self.dropped = 0   # samples rejected (overlong feature/transcript)

    def add(self, feats: np.ndarray, labels: Sequence[int]
            ) -> Optional[Batch]:
        b = bucket_for(len(feats), self.boundaries)   # None: overlong
        if b is None or len(labels) > self.max_label_len:
            self.dropped += 1
            return None
        bin_ = self._bins[b]
        bin_.append((feats, list(labels)))
        if len(bin_) >= self.batch_size:
            self._bins[b] = []
            return self._make_batch(bin_, b)
        return None

    def drain(self) -> List[Batch]:
        out = []
        for b, bin_ in self._bins.items():
            if bin_:
                while len(bin_) < self.batch_size:   # pad batch dim
                    # zero-LENGTH filler rows: feature_lengths == 0 marks
                    # them as padding, not one-frame utterances
                    bin_.append((bin_[0][0][:0], []))
                out.append(self._make_batch(bin_, b))
        self._bins = {b: [] for b in self.boundaries}
        return out

    def _make_batch(self, items, pad_t: int) -> Batch:
        B = len(items)
        F = items[0][0].shape[-1]
        feats = np.zeros((B, pad_t, F), np.float32)
        flens = np.zeros((B,), np.int32)
        labels = np.zeros((B, self.max_label_len), np.int32)
        llens = np.zeros((B,), np.int32)
        for i, (f, l) in enumerate(items):
            feats[i, :len(f)] = f
            flens[i] = len(f)
            labels[i, :len(l)] = l
            llens[i] = len(l)
        return Batch(feats, flens, labels, llens)


def speech_batches(manifest_path: str, *, batch_size: int = 8,
                   n_buckets: int = 3, max_label_len: int = 32,
                   featurize: Optional[Callable] = None,
                   alphabet: str = ALPHABET,
                   sort_by_size: bool = True,
                   device="cuda") -> Iterator[Batch]:
    """Manifest (CSV or SDB) -> featurized, bucketed, padded batches
    (create_dataset). ``featurize(audio) -> [T, F]`` defaults to the MFCC
    front end on ``device``."""
    from tosem_tpu_torch.data.sample_collections import open_collection
    coll = open_collection(manifest_path)   # CSV manifest or SDB bundle
    if sort_by_size:
        coll = coll.sorted_by_size()
    if featurize is None:
        import torch

        from tosem_tpu_torch.data.audio import mfcc
        from tosem_tpu_torch.ops.common import resolve_device
        dev = resolve_device(device)

        def featurize(a):
            return mfcc(torch.from_numpy(np.asarray(a, np.float32))
                        .to(dev)).cpu().numpy()
    prepared = []
    for s in coll:
        feats = featurize(s.load_audio())
        labels = text_to_labels(s.transcript, alphabet)
        prepared.append((feats, labels))
    bounds = bucket_boundaries([len(f) for f, _ in prepared], n_buckets)
    batcher = BucketedBatcher(batch_size, bounds, max_label_len)
    for feats, labels in prepared:
        b = batcher.add(feats, labels)
        if b is not None:
            yield b
    yield from batcher.drain()
    if batcher.dropped:
        import warnings
        warnings.warn(f"speech_batches dropped {batcher.dropped}/"
                      f"{len(prepared)} samples (overlong transcript or "
                      "feature sequence); raise max_label_len/n_buckets "
                      "to include them")
