"""Record/replay of channel messages (Cyber record analog).

Apollo records channel traffic to `.record` files and replays them with
original timing (`cyber/record/record_writer.cc`, `record_reader.cc`,
`cyber_recorder`). Here a :class:`Recorder` appends (topic, t, payload)
rows to the cluster KV's SQLite file — one durable artifact shared with
experiment state — and :func:`replay` yields them back in time order,
optionally respecting inter-message gaps. ``replay_source`` adapts a
recording into a dataflow source so a recorded pipeline run can be
re-driven through a dataflow graph
(:class:`~tosem_tpu_torch.dataflow.graph.StreamGraph`) — the
record-then-replay debugging loop perception teams use.

A copy of the JAX package's ``cluster/replay.py``.
"""
from __future__ import annotations

import pickle
import sqlite3
import threading
import time
from typing import Any, Iterator, List, Optional, Tuple


class Recorder:
    def __init__(self, path: str):
        self.path = path
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS record ("
                "id INTEGER PRIMARY KEY AUTOINCREMENT, topic TEXT NOT NULL,"
                "t REAL NOT NULL, payload BLOB NOT NULL)")
            self._db.commit()

    def write(self, topic: str, message: Any,
              t: Optional[float] = None) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO record (topic, t, payload) VALUES (?, ?, ?)",
                (topic, time.time() if t is None else t,
                 pickle.dumps(message)))
            self._db.commit()

    def topics(self) -> List[str]:
        with self._lock:
            rows = self._db.execute(
                "SELECT DISTINCT topic FROM record ORDER BY topic").fetchall()
        return [r[0] for r in rows]

    def count(self, topic: Optional[str] = None) -> int:
        with self._lock:
            if topic is None:
                row = self._db.execute(
                    "SELECT COUNT(*) FROM record").fetchone()
            else:
                row = self._db.execute(
                    "SELECT COUNT(*) FROM record WHERE topic=?",
                    (topic,)).fetchone()
        return int(row[0])

    def tap(self, topic: str, fn=None):
        """Wrap a dataflow operator (or identity) so every item passing
        through is recorded — the `cyber_recorder record` role inside a
        running pipeline."""
        def op(item):
            self.write(topic, item)
            return item if fn is None else fn(item)
        return op

    def close(self) -> None:
        with self._lock:
            self._db.close()


def replay(path: str, topic: Optional[str] = None, *,
           realtime: bool = False,
           speed: float = 1.0) -> Iterator[Tuple[str, float, Any]]:
    """Yield (topic, t, message) in recorded order. ``realtime=True``
    sleeps the original inter-message gaps (scaled by ``speed``) — the
    `cyber_recorder play --rate` behavior."""
    db = sqlite3.connect(path)
    try:
        if topic is None:
            rows = db.execute(
                "SELECT topic, t, payload FROM record ORDER BY t, id")
        else:
            rows = db.execute(
                "SELECT topic, t, payload FROM record WHERE topic=? "
                "ORDER BY t, id", (topic,))
        prev_t = None
        for top, t, payload in rows:
            if realtime and prev_t is not None and t > prev_t:
                time.sleep((t - prev_t) / speed)
            prev_t = t
            yield top, t, pickle.loads(payload)
    finally:
        db.close()


def replay_source(path: str, topic: str) -> List[Any]:
    """Materialize one topic's messages as a dataflow source iterable."""
    return [msg for _, _, msg in replay(path, topic)]
