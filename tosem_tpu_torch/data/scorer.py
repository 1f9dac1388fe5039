"""Scorer package tooling: build an n-gram LM for the native beam decoder.

A copy of ``tosem_tpu/data/scorer.py`` (no JAX there, but the port keeps
its own). The role of DeepSpeech's ``generate_scorer_package`` / ``data/lm``
pipeline (corpus → KenLM arpa → trie → ``.scorer`` file,
``native_client/generate_scorer_package.cpp``): here a corpus of text is
counted into a backoff n-gram model over *words as label-id sequences*
and serialized to a compact binary (``TLM1``) that
``tosem_tpu_torch/native/ctc_decoder.cpp`` loads into a hash table + vocabulary trie.
Log-probabilities are relative-frequency estimates
``log(c(ngram)/c(context))``; the decoder applies a fixed stupid-backoff
penalty per shortened context level, so no discounting machinery is
needed at build time.
"""
from __future__ import annotations

import collections
import math
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from tosem_tpu_torch.data.audio import ALPHABET, text_to_labels

MAGIC = b"TLM1"


def _tokenize(text: str, alphabet: str) -> List[str]:
    keep = set(alphabet)
    cleaned = "".join(ch for ch in text.lower() if ch in keep)
    return [w for w in cleaned.split() if w]


def build_scorer(texts: Iterable[str], path: str, *,
                 alphabet: str = ALPHABET, order: int = 3,
                 backoff: float = 0.4,
                 unk_logp: float | None = None) -> Dict[str, int]:
    """Count n-grams over ``texts`` and write the binary LM to ``path``.

    Returns the vocabulary (word → id) for callers that need to map
    hypotheses back to ids (tests, hot-word tooling).
    """
    if not 1 <= order <= 5:
        raise ValueError("order must be in [1, 5]")
    vocab: Dict[str, int] = {}
    counts: List[collections.Counter] = [collections.Counter()
                                         for _ in range(order)]
    total_tokens = 0
    for text in texts:
        words = _tokenize(text, alphabet)
        ids = []
        for w in words:
            if w not in vocab:
                vocab[w] = len(vocab)
            ids.append(vocab[w])
        total_tokens += len(ids)
        for n in range(1, order + 1):
            for i in range(len(ids) - n + 1):
                counts[n - 1][tuple(ids[i:i + n])] += 1
    if total_tokens == 0:
        raise ValueError("empty corpus")
    if unk_logp is None:
        unk_logp = -math.log(total_tokens * 10.0)

    entries: List[Tuple[Tuple[int, ...], float]] = []
    for gram, c in counts[0].items():
        entries.append((gram, math.log(c / total_tokens)))
    for n in range(2, order + 1):
        ctx_counts = counts[n - 2]
        for gram, c in counts[n - 1].items():
            entries.append((gram, math.log(c / ctx_counts[gram[:-1]])))

    words_by_id = sorted(vocab.items(), key=lambda kv: kv[1])
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<iiff", order, len(vocab), unk_logp,
                            math.log(backoff)))
        for w, _ in words_by_id:
            labels = text_to_labels(w, alphabet)
            f.write(struct.pack("<i", len(labels)))
            f.write(struct.pack(f"<{len(labels)}i", *labels))
        f.write(struct.pack("<i", len(entries)))
        for gram, logp in entries:
            f.write(struct.pack("<i", len(gram)))
            f.write(struct.pack(f"<{len(gram)}i", *gram))
            f.write(struct.pack("<f", logp))
        # trailing alphabet stamp: the C++ loader reads exactly the
        # entries above and ignores this; Python readers use it to
        # reject packages built against a different label mapping
        ab = alphabet.encode()
        f.write(struct.pack("<I", len(ab)))
        f.write(ab)
    return vocab


def read_scorer_alphabet(path: str) -> Optional[str]:
    """Return the alphabet a scorer package was built with (None for
    packages predating the stamp)."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"not a scorer package: {path}")
        order, n_words, _, _ = struct.unpack("<iiff", f.read(16))
        for _ in range(n_words):
            (n,) = struct.unpack("<i", f.read(4))
            f.seek(4 * n, 1)
        (n_entries,) = struct.unpack("<i", f.read(4))
        for _ in range(n_entries):
            (n,) = struct.unpack("<i", f.read(4))
            f.seek(4 * n + 4, 1)
        tail = f.read(4)
        if len(tail) < 4:
            return None
        (ab_len,) = struct.unpack("<I", tail)
        ab = f.read(ab_len)
        return ab.decode() if len(ab) == ab_len else None
