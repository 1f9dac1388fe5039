"""Durable small-KV and queue (GCS table / Redis / DB-queue analogs).

The reference persists cluster and experiment state in three places this
module collapses: Ray's GCS tables + Redis primary (`src/ray/gcs/
gcs_server/`, cluster metadata and named resources), NNI's experiment
database (`nni/experiment/`, sqlite), and the MySQL-backed trial queues
of the study scripts. One SQLite file serves all three roles — a
deliberate single-host simplification (SURVEY §3.1 collapses the GCS
into the driver), but with the same API shape so a future gRPC/DCN
backend can slot in behind it.

Thread-safe; values are bytes (callers bring their own serialization —
JSON for manifests, pickle for handles).

A copy of the JAX package's ``cluster/kv.py``.
"""
from __future__ import annotations

import os
import sqlite3
import threading
import time
from typing import List, Optional, Tuple


class KVStore:
    """Namespaced persistent KV with compare-and-swap."""

    # pop()'s single-statement lease needs UPDATE..RETURNING (SQLite
    # >= 3.35); older engines fall back to SELECT+UPDATE under the
    # in-process lock — same semantics within one process, but NOT
    # atomic across processes sharing the db file
    _HAS_RETURNING = sqlite3.sqlite_version_info >= (3, 35)

    def __init__(self, path: str = ":memory:"):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "ns TEXT NOT NULL, k TEXT NOT NULL, v BLOB NOT NULL, "
                "updated REAL NOT NULL, PRIMARY KEY (ns, k))")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS q ("
                "id INTEGER PRIMARY KEY AUTOINCREMENT, qname TEXT NOT NULL,"
                "payload BLOB NOT NULL, state TEXT NOT NULL DEFAULT 'ready',"
                "leased REAL)")
            self._db.commit()

    # ------------------------------------------------------------- KV

    def put(self, ns: str, key: str, value: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO kv (ns, k, v, updated) VALUES (?, ?, ?, ?) "
                "ON CONFLICT (ns, k) DO UPDATE SET v=excluded.v, "
                "updated=excluded.updated",
                (ns, key, value, time.time()))
            self._db.commit()

    def get(self, ns: str, key: str) -> Optional[bytes]:
        with self._lock:
            row = self._db.execute(
                "SELECT v FROM kv WHERE ns=? AND k=?", (ns, key)).fetchone()
        return None if row is None else bytes(row[0])

    def delete(self, ns: str, key: str) -> bool:
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM kv WHERE ns=? AND k=?", (ns, key))
            self._db.commit()
            return cur.rowcount > 0

    def put_if_other(self, ns: str, key: str, value: bytes,
                     guard_ns: str, guard_key: str,
                     guard_expect: bytes) -> bool:
        """Upsert (ns, key) only while another row still holds an
        expected value — one SQL statement, so it is atomic across
        processes. The write-while-holding-the-lock primitive (a
        displaced lock holder must not clobber its successor's state)."""
        with self._lock:
            cur = self._db.execute(
                "INSERT INTO kv (ns, k, v, updated) "
                "SELECT ?, ?, ?, ? WHERE EXISTS "
                "(SELECT 1 FROM kv WHERE ns=? AND k=? AND v=?) "
                "ON CONFLICT (ns, k) DO UPDATE SET v=excluded.v, "
                "updated=excluded.updated",
                (ns, key, value, time.time(),
                 guard_ns, guard_key, guard_expect))
            self._db.commit()
            return cur.rowcount > 0

    def delete_if(self, ns: str, key: str, expect: bytes) -> bool:
        """Atomic compare-and-delete (single statement — safe across
        processes): removes the row only if it still holds ``expect``.
        The lock-release primitive: a displaced holder must not delete
        its successor's lock."""
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM kv WHERE ns=? AND k=? AND v=?",
                (ns, key, expect))
            self._db.commit()
            return cur.rowcount > 0

    def keys(self, ns: str, prefix: str = "") -> List[str]:
        # escape LIKE metacharacters so '_'/'%' in a prefix match literally
        esc = (prefix.replace("\\", "\\\\").replace("%", "\\%")
               .replace("_", "\\_"))
        with self._lock:
            rows = self._db.execute(
                "SELECT k FROM kv WHERE ns=? AND k LIKE ? ESCAPE '\\' "
                "ORDER BY k", (ns, esc + "%")).fetchall()
        return [r[0] for r in rows]

    def cas(self, ns: str, key: str, expect: Optional[bytes],
            value: bytes) -> bool:
        """Compare-and-swap: write only if the current value matches
        ``expect`` (None = key must not exist). Single-statement SQL, so
        it is atomic across processes sharing the db file — the primitive
        behind leader election / unique named registration."""
        with self._lock:
            if expect is None:
                cur = self._db.execute(
                    "INSERT OR IGNORE INTO kv (ns, k, v, updated) "
                    "VALUES (?, ?, ?, ?)", (ns, key, value, time.time()))
            else:
                cur = self._db.execute(
                    "UPDATE kv SET v=?, updated=? WHERE ns=? AND k=? "
                    "AND v=?", (value, time.time(), ns, key, expect))
            self._db.commit()
            return cur.rowcount > 0

    # ------------------------------------------------ durable queue

    def push(self, qname: str, payload: bytes) -> int:
        with self._lock:
            cur = self._db.execute(
                "INSERT INTO q (qname, payload) VALUES (?, ?)",
                (qname, payload))
            self._db.commit()
            return int(cur.lastrowid)

    def pop(self, qname: str) -> Optional[Tuple[int, bytes]]:
        """Lease the oldest ready item (at-least-once: ack() to finish,
        reap() returns expired leases to ready — the work-queue pattern
        the study's MySQL queue implements)."""
        with self._lock:
            if self._HAS_RETURNING:
                # single statement so the lease is atomic across
                # *processes* sharing the db file — a SELECT then UPDATE
                # pair lets two processes lease the same item
                row = self._db.execute(
                    "UPDATE q SET state='leased', leased=? WHERE id=("
                    "SELECT id FROM q WHERE qname=? AND state='ready' "
                    "ORDER BY id LIMIT 1) RETURNING id, payload",
                    (time.time(), qname)).fetchone()
            else:
                # SELECT + guarded UPDATE: the AND state='ready' guard +
                # rowcount check narrows (not closes) the cross-process
                # race — if another process won the lease, retry instead
                # of double-leasing
                row = None
                for _ in range(8):
                    cand = self._db.execute(
                        "SELECT id, payload FROM q WHERE qname=? AND "
                        "state='ready' ORDER BY id LIMIT 1",
                        (qname,)).fetchone()
                    if cand is None:
                        break
                    cur = self._db.execute(
                        "UPDATE q SET state='leased', leased=? WHERE "
                        "id=? AND state='ready'",
                        (time.time(), cand[0]))
                    if cur.rowcount == 1:
                        row = cand
                        break
                    self._db.commit()   # lost the race; observe fresh state
            self._db.commit()
            if row is None:
                return None
            return int(row[0]), bytes(row[1])

    def ack(self, item_id: int) -> None:
        with self._lock:
            self._db.execute("DELETE FROM q WHERE id=?", (item_id,))
            self._db.commit()

    def reap(self, qname: str, lease_timeout: float) -> int:
        with self._lock:
            cur = self._db.execute(
                "UPDATE q SET state='ready', leased=NULL WHERE qname=? "
                "AND state='leased' AND leased < ?",
                (qname, time.time() - lease_timeout))
            self._db.commit()
            return cur.rowcount

    def qsize(self, qname: str) -> int:
        with self._lock:
            row = self._db.execute(
                "SELECT COUNT(*) FROM q WHERE qname=? AND state='ready'",
                (qname,)).fetchone()
        return int(row[0])

    def close(self) -> None:
        with self._lock:
            self._db.close()
