"""Sample collections — random-access binary sample bundles + importers.

The reference ships two on-disk corpus formats (DeepSpeech
``training/deepspeech_training/util/sample_collections.py``): CSV
manifests pointing at WAV files, and SDB — a single-file binary sample
database (``MAGIC = b'SAMPLEDB'``, trailing offset index, random access)
that trains faster than thousands of small files. Plus ~30 ``bin/
import_*.py`` corpus importers, of which ``import_ldc93s1.py`` (one
utterance) is what its CI trains on.

The port's copy of ``tosem_tpu/data/sample_collections.py``:

- :class:`SDBWriter` / :class:`SDBReader` — single-file bundle ``TSDB1``:
  raw 16-bit PCM payloads back-to-back, one JSON index at the tail,
  mmap-backed zero-copy reads (the host side of an input pipeline that
  must keep an accelerator fed: no per-sample ``open()``).
- :func:`csv_to_sdb` — the ``bin/build_sdb.py`` role.
- :func:`open_collection` — sniffs CSV vs SDB so every consumer
  (``speech_batches``, the ``speech_train`` CLI config) takes either.
- :func:`import_ldc93s1` — the ``bin/import_ldc93s1.py`` role, offline:
  parses a local LDC93S1-style wav+transcript pair with the reference's
  exact transcript normalization (lowercase, drop the leading two tokens,
  strip periods) and writes the standard CSV manifest. ``fabricate=True``
  synthesizes the pair first (hermetic CI, the --use_fake_data way).

Layout of a ``.sdb`` file::

    b"TSDB1"  | payload bytes ... | index JSON | u64 index_off | u32 index_len
"""
from __future__ import annotations

import csv
import json
import mmap
import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

MAGIC = b"TSDB1"
_TAIL = struct.Struct("<QI")          # index offset, index length


@dataclass
class BundledSample:
    """One utterance stored inside an SDB bundle (zero-copy payload)."""
    _buf: memoryview
    offset: int
    nbytes: int
    transcript: str
    sample_rate: int
    sample_id: str
    duration_s: float

    @property
    def size_bytes(self) -> int:       # SampleCollection sort key
        return self.nbytes

    def load_audio(self) -> np.ndarray:
        pcm = np.frombuffer(self._buf, np.int16,
                            count=self.nbytes // 2, offset=self.offset)
        return pcm.astype(np.float32) / 32768.0


class SDBWriter:
    """Streaming writer; the index lands at the tail on close (so writing
    is append-only, the DirectSDBWriter property)."""

    def __init__(self, path: str, *, sample_rate: int = 16000):
        self.path = path
        self.sample_rate = sample_rate
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._entries: List[dict] = []
        self._closed = False

    def add(self, audio: np.ndarray, transcript: str,
            sample_id: Optional[str] = None,
            sample_rate: Optional[int] = None) -> None:
        """``audio``: float waveform in [-1, 1] or int16 PCM."""
        if self._closed:
            raise ValueError("writer is closed")
        a = np.asarray(audio)
        if a.dtype != np.int16:
            a = np.clip(a * 32767.0, -32768, 32767).astype(np.int16)
        blob = a.tobytes()
        rate = sample_rate or self.sample_rate
        self._entries.append({
            "offset": self._f.tell(), "nbytes": len(blob),
            "transcript": transcript,
            "sample_id": sample_id or f"sample{len(self._entries):06d}",
            "sample_rate": rate,
            "duration_s": round(len(a) / rate, 6)})
        self._f.write(blob)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        index = json.dumps({"version": 1, "sample_rate": self.sample_rate,
                            "entries": self._entries},
                           separators=(",", ":")).encode()
        off = self._f.tell()
        self._f.write(index)
        self._f.write(_TAIL.pack(off, len(index)))
        self._f.close()

    def __enter__(self) -> "SDBWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self._entries)


class SDBReader:
    """mmap-backed random access; samples decode lazily on load_audio."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a TSDB1 sample bundle")
        off, ln = _TAIL.unpack_from(self._mm, len(self._mm) - _TAIL.size)
        if off + ln + _TAIL.size > len(self._mm):
            raise ValueError(f"{path}: corrupt index tail")
        index = json.loads(self._mm[off:off + ln].decode())
        self.sample_rate = int(index.get("sample_rate", 16000))
        buf = memoryview(self._mm)
        self.samples = [BundledSample(
            buf, e["offset"], e["nbytes"], e["transcript"],
            int(e.get("sample_rate", self.sample_rate)),
            e.get("sample_id", f"sample{i:06d}"),
            float(e.get("duration_s", 0.0)))
            for i, e in enumerate(index["entries"])]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> BundledSample:
        return self.samples[i]

    def __iter__(self) -> Iterator[BundledSample]:
        return iter(self.samples)

    def sorted_by_size(self) -> "SDBReader":
        out = object.__new__(SDBReader)
        out.path, out._file, out._mm = self.path, self._file, self._mm
        out.sample_rate = self.sample_rate
        out.samples = sorted(self.samples, key=lambda s: s.size_bytes)
        return out

    def close(self) -> None:
        # samples hold memoryviews into the map; drop them first
        self.samples = []
        self._mm.close()
        self._file.close()


def csv_to_sdb(manifest_path: str, sdb_path: str,
               sample_rate: int = 16000) -> str:
    """Bundle a CSV manifest's WAVs into one SDB (bin/build_sdb.py)."""
    from tosem_tpu_torch.data.feeding import read_csv_manifest
    coll = read_csv_manifest(manifest_path)
    with SDBWriter(sdb_path, sample_rate=sample_rate) as w:
        for s in coll:
            w.add(s.load_audio(), s.transcript)
    return sdb_path


def open_collection(path: str):
    """CSV manifest or SDB bundle → iterable sample collection (the
    samples_from_source dispatch of the reference)."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
    if head == MAGIC:
        return SDBReader(path)
    from tosem_tpu_torch.data.feeding import read_csv_manifest
    return read_csv_manifest(path)


# ---------------------------------------------------------------------------
# LDC93S1 importer
# ---------------------------------------------------------------------------

LDC93S1_TEXT = ("0 97600 She had your dark suit in greasy wash water "
                "all year.")


def _normalize_ldc_transcript(raw: str) -> str:
    """The reference's exact rule (bin/import_ldc93s1.py:21-23): strip,
    lowercase is applied via .lower(), drop the two leading sample-range
    tokens, remove periods."""
    return " ".join(raw.strip().lower().split(" ")[2:]).replace(".", "")


def import_ldc93s1(data_dir: str, *, wav_path: Optional[str] = None,
                   txt_path: Optional[str] = None,
                   fabricate: bool = False) -> str:
    """Produce ``ldc93s1.csv`` from a local LDC93S1-style wav+txt pair.

    Offline analog of ``bin/import_ldc93s1.py`` (which downloads the pair;
    this environment has zero egress, so the files must exist locally or
    ``fabricate=True`` synthesizes a stand-in utterance with the canonical
    transcript file format so the full import→train path still runs).
    """
    os.makedirs(data_dir, exist_ok=True)
    wav = wav_path or os.path.join(data_dir, "LDC93S1.wav")
    txt = txt_path or os.path.join(data_dir, "LDC93S1.txt")
    if not (os.path.exists(wav) and os.path.exists(txt)):
        if not fabricate:
            raise FileNotFoundError(
                f"LDC93S1.wav/.txt not found under {data_dir}; place the "
                "corpus files there or pass fabricate=True for a "
                "synthesized stand-in")
        import wave
        rng = np.random.default_rng(93)
        t = np.arange(int(1.5 * 16000)) / 16000.0
        sig = (0.3 * np.sin(2 * np.pi * 150 * t)
               + 0.1 * rng.normal(size=t.shape))
        pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int16)
        with wave.open(wav, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        with open(txt, "w") as f:
            f.write(LDC93S1_TEXT + "\n")
    with open(txt) as f:
        transcript = _normalize_ldc_transcript(f.read())
    manifest = os.path.join(data_dir, "ldc93s1.csv")
    with open(manifest, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["wav_filename", "wav_filesize", "transcript"])
        w.writerow([os.path.abspath(wav), os.path.getsize(wav), transcript])
    return manifest
