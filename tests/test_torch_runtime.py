"""The port's actor runtime and object store, held to the JAX package's
own runtime tests.

Copies, against :mod:`tosem_tpu_torch.runtime`, of ``tests/test_runtime.py``
(object store, tasks, actors, kill-based fault injection, regressions,
cancel, duplicate-done idempotency) and all of
``tests/test_object_store_lifecycle.py`` (two-phase writes, orphan
reclamation, the spill tier). The microbenchmark smoke is in
``tests/test_torch_bench_runtime.py``. Left out: the head-of-line test,
whose pass rests on a wall-clock budget (C-ref2). The start-method test is the
port's rule: spawn once torch is loaded. The store-name tests hold the
port's segments apart from the JAX package's.
"""
import os
import subprocess
import sys
import time

import pytest
import torch

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.runtime.object_store import (ID_LEN, ObjectID,
                                                  ObjectStore,
                                                  ObjectStoreError)

torch.set_num_threads(1)


# --------------------------------------------------------------- object store

class TestObjectStore:
    def test_put_get_roundtrip(self):
        with ObjectStore(
                f"/tosem_torch_t1_{os.getpid()}", capacity=4 << 20) as s:
            oid = ObjectID.random()
            s.put(oid, b"hello world")
            assert s.get(oid) == b"hello world"
            assert s.contains(oid)
            assert s.get(ObjectID.random()) is None

    def test_immutability(self):
        from tosem_tpu_torch.runtime.object_store import ObjectStoreError
        with ObjectStore(
                f"/tosem_torch_t2_{os.getpid()}", capacity=4 << 20) as s:
            oid = ObjectID.random()
            s.put(oid, b"v1")
            with pytest.raises(ObjectStoreError):
                s.put(oid, b"v2")

    def test_delete_and_reuse(self):
        with ObjectStore(
                f"/tosem_torch_t3_{os.getpid()}", capacity=4 << 20) as s:
            for _ in range(50):  # churn: delete must free space
                oid = ObjectID.random()
                s.put(oid, b"x" * (200 << 10))
                s.delete(oid)
            used, n, _ = s.stats()
            assert n == 0 and used == 0

    def test_delete_under_reader_is_deferred(self):
        # get() contract: the zero-copy pointer stays valid until refcount 0,
        # so delete-under-readers must defer the free to the last release
        with ObjectStore(
                f"/tosem_torch_t3d_{os.getpid()}", capacity=4 << 20) as s:
            oid = ObjectID.random()
            payload = b"y" * (100 << 10)
            s.put(oid, payload)
            view = s.get_view(oid)
            s.delete(oid)
            s.delete(oid)                     # double delete: idempotent
            assert not s.contains(oid)        # invisible to new lookups
            assert s.get(oid) is None
            assert bytes(view) == payload     # existing view still valid
            used, n, _ = s.stats()
            assert n == 1 and used > 0        # space NOT yet reclaimed
            del view
            s.release(oid)                    # last reader → deferred free
            used, n, _ = s.stats()
            assert n == 0 and used == 0

    def test_lru_eviction_under_pressure(self):
        with ObjectStore(
                f"/tosem_torch_t4_{os.getpid()}", capacity=4 << 20) as s:
            first = ObjectID.random()
            s.put(first, b"a" * (1 << 20))
            for _ in range(8):  # exceeds capacity → evicts LRU
                s.put(ObjectID.random(), b"b" * (1 << 20))
            assert not s.contains(first)
            _, n, _ = s.stats()
            assert n >= 1

    def test_pinned_objects_survive_eviction(self):
        with ObjectStore(
                f"/tosem_torch_t5_{os.getpid()}", capacity=4 << 20) as s:
            pinned = ObjectID.random()
            s.put(pinned, b"p" * (1 << 20))
            view = s.get_view(pinned)  # refcount > 0 pins it
            for _ in range(8):
                s.put(ObjectID.random(), b"b" * (1 << 20))
            assert s.contains(pinned)
            assert bytes(view[:1]) == b"p"
            s.release(pinned)

    def test_cross_process_visibility(self):
        import subprocess
        import sys
        name = f"/tosem_torch_t6_{os.getpid()}"
        with ObjectStore(name, capacity=4 << 20) as s:
            code = (
                "from tosem_tpu_torch.runtime.object_store import ObjectStore, "
                "ObjectID\n"
                f"st = ObjectStore({name!r}, create=False)\n"
                "st.put(ObjectID(bytes(20)), b'from-child')\n")
            subprocess.run([sys.executable, "-c", code], check=True,
                           cwd=os.path.dirname(os.path.dirname(__file__)))
            assert s.get(ObjectID(bytes(20))) == b"from-child"


# ------------------------------------------------------------------- runtime

@pytest.fixture(scope="module")
def runtime():
    rt.init(num_workers=3)
    yield rt
    rt.shutdown()


class TestTasks:
    def test_task_roundtrip(self, runtime):
        @rt.remote
        def double(x):
            return x * 2
        assert rt.get(double.remote(21)) == 42

    def test_fanout(self, runtime):
        @rt.remote
        def sq(x):
            return x * x
        refs = [sq.remote(i) for i in range(40)]
        assert rt.get(refs) == [i * i for i in range(40)]

    def test_dependency_chaining(self, runtime):
        @rt.remote
        def inc(x):
            return x + 1
        ref = inc.remote(0)
        for _ in range(5):
            ref = inc.remote(ref)
        assert rt.get(ref) == 6

    def test_put_large_object_via_store(self, runtime):
        data = os.urandom(1 << 20)  # > INLINE_THRESHOLD → shm store
        assert rt.get(rt.put(data)) == data

    def test_large_task_result(self, runtime):
        @rt.remote
        def big():
            return b"z" * (1 << 20)
        assert rt.get(big.remote()) == b"z" * (1 << 20)

    def test_large_arg_through_store(self, runtime):
        data = os.urandom(512 << 10)
        ref = rt.put(data)

        @rt.remote
        def length(b):
            return len(b)
        assert rt.get(length.remote(ref)) == len(data)

    def test_error_propagation(self, runtime):
        @rt.remote
        def boom():
            raise ValueError("expected failure")
        with pytest.raises(rt.TaskError, match="expected failure"):
            rt.get(boom.remote())

    def test_wait_semantics(self, runtime):
        @rt.remote
        def sleepy(t):
            time.sleep(t)
            return t
        fast = [sleepy.remote(0.01) for _ in range(3)]
        slow = sleepy.remote(5.0)
        done, pending = rt.wait(fast + [slow], num_returns=3, timeout=10)
        assert len(done) == 3 and slow in pending

    def test_get_timeout(self, runtime):
        @rt.remote
        def forever():
            time.sleep(60)
        with pytest.raises(TimeoutError):
            rt.get(forever.remote(), timeout=0.2)


class TestActors:
    def test_stateful_counter(self, runtime):
        @rt.remote
        class Counter:
            def __init__(self, start=0):
                self.n = start

            def inc(self, k=1):
                self.n += k
                return self.n

        c = Counter.remote(10)
        assert rt.get(c.inc.remote()) == 11
        assert rt.get(c.inc.remote(9)) == 20

    def test_call_ordering(self, runtime):
        @rt.remote
        class Appender:
            def __init__(self):
                self.log = []

            def add(self, x):
                self.log.append(x)
                return list(self.log)

        a = Appender.remote()
        refs = [a.add.remote(i) for i in range(10)]
        assert rt.get(refs[-1]) == list(range(10))

    def test_actor_init_error(self, runtime):
        @rt.remote
        class Bad:
            def __init__(self):
                raise RuntimeError("ctor fails")

            def ping(self):
                return 1

        b = Bad.remote()
        with pytest.raises((rt.TaskError, rt.ActorDiedError)):
            rt.get(b.ping.remote(), timeout=10)


class TestFaultInjection:
    """Kill-based tests, the `test_component_failures.py` pattern."""

    def test_task_retry_after_worker_death(self, runtime, tmp_path):
        marker = str(tmp_path / "died_once")

        @rt.remote
        def die_once(path):
            if not os.path.exists(path):
                open(path, "w").close()
                os._exit(1)  # hard kill, no cleanup
            return "recovered"

        assert rt.get(die_once.remote(marker), timeout=30) == "recovered"

    def test_retries_exhausted_raises(self, runtime):
        @rt.remote
        def always_die():
            os._exit(1)

        with pytest.raises(rt.WorkerCrashedError):
            rt.get(always_die.options(max_retries=1).remote(), timeout=30)

    def test_actor_restart_policy(self, runtime):
        @rt.remote(max_restarts=1)
        class Phoenix:
            def crash(self):
                os._exit(1)

            def ping(self):
                return "pong"

        p = Phoenix.remote()
        with pytest.raises(rt.ActorDiedError):
            rt.get(p.crash.remote(), timeout=30)
        deadline = time.time() + 10   # restarted replica must answer
        while True:
            try:
                assert rt.get(p.ping.remote(), timeout=10) == "pong"
                break
            except rt.ActorDiedError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)

    def test_kill_is_permanent(self, runtime):
        @rt.remote(max_restarts=5)
        class Immortal:
            def ping(self):
                return "pong"

        im = Immortal.remote()
        assert rt.get(im.ping.remote(), timeout=10) == "pong"
        rt.kill(im)
        time.sleep(0.3)
        with pytest.raises(rt.ActorDiedError):
            rt.get(im.ping.remote(), timeout=10)

    def test_pool_survives_repeated_crashes(self, runtime):
        @rt.remote
        def crash():
            os._exit(1)

        @rt.remote
        def ok(x):
            return x

        for ref in [crash.options(max_retries=0).remote() for _ in range(3)]:
            with pytest.raises(rt.WorkerCrashedError):
                rt.get(ref, timeout=30)
        assert rt.get([ok.remote(i) for i in range(9)],
                      timeout=30) == list(range(9))


class TestRegressions:
    def test_wait_num_returns_exceeds_refs(self, runtime):
        @rt.remote
        def one():
            return 1
        refs = [one.remote()]
        with pytest.raises(ValueError):
            rt.wait(refs, num_returns=2, timeout=1)

    def test_unpicklable_exception_reported_not_crash(self, runtime):
        @rt.remote
        def raise_unpicklable():
            import threading
            e = RuntimeError("real error message")
            e.lock = threading.Lock()  # unpicklable attribute
            raise e
        with pytest.raises(rt.TaskError, match="real error message"):
            rt.get(raise_unpicklable.remote(), timeout=30)

    def test_object_table_gc_on_ref_drop(self, runtime):
        import gc
        from tosem_tpu_torch.runtime.api import _rt
        r = _rt()
        before = len(r.inline)
        @rt.remote
        def val(i):
            return i
        refs = [val.remote(i) for i in range(50)]
        rt.get(refs)
        assert len(r.inline) >= before + 50
        del refs
        gc.collect()
        time.sleep(0.1)
        assert len(r.inline) <= before + 5  # finalizers reclaimed entries

    def test_kill_with_inflight_call_resolves_ref(self, runtime):
        @rt.remote
        class Sleeper:
            def nap(self):
                time.sleep(30)
                return "woke"
        s = Sleeper.remote()
        ref = s.nap.remote()
        time.sleep(0.3)  # let the call start
        rt.kill(s)
        with pytest.raises(rt.ActorDiedError):
            rt.get(ref, timeout=10)  # must NOT hang forever

    def test_many_large_actor_messages_no_deadlock(self, runtime):
        # 90KB payloads exceed the OS pipe buffer: exercises the sender
        # thread (a blocking send under the runtime lock would deadlock)
        @rt.remote
        class EchoBig:
            def echo(self, b):
                return b
        a = EchoBig.remote()
        payload = b"x" * (90 << 10)
        refs = [a.echo.remote(payload) for _ in range(30)]
        out = rt.get(refs, timeout=60)
        assert all(o == payload for o in out)

    def test_tiny_store_capacity_is_clamped(self):
        name = f"/tosem_torch_t7_{os.getpid()}"
        with ObjectStore(name, capacity=64 << 10) as s:  # absurdly small
            oid = ObjectID.random()
            s.put(oid, b"y" * 100_000)  # still fits: clamped to min capacity
            assert s.get(oid) == b"y" * 100_000


class TestCancel:
    def test_cancel_running_task_kills_and_respawns(self, runtime):
        @rt.remote
        def hang():
            time.sleep(120)

        ref = hang.remote()
        time.sleep(0.5)  # let the worker start grinding
        rt.cancel(ref)
        with pytest.raises(rt.TaskCancelledError):
            rt.get(ref, timeout=10)

        @rt.remote
        def quick():
            return 7

        # the killed slot respawned; pool still serves work
        assert rt.get(quick.remote(), timeout=30) == 7

    def test_cancel_pending_task(self, runtime):
        @rt.remote
        def dep():
            time.sleep(120)

        @rt.remote
        def child(x):
            return x

        blocker = dep.remote()
        ref = child.remote(blocker)   # dep never resolves → stays pending
        rt.cancel(ref)
        with pytest.raises(rt.TaskCancelledError):
            rt.get(ref, timeout=10)
        rt.cancel(blocker)

    def test_cancel_finished_task_is_noop(self, runtime):
        @rt.remote
        def f():
            return 1

        ref = f.remote()
        assert rt.get(ref, timeout=30) == 1
        rt.cancel(ref)
        assert rt.get(ref) == 1


class TestStartMethod:
    def test_auto_spawn_when_torch_loaded(self):
        # this module imports torch, so the fork default must flip to
        # spawn (a forked child cannot re-initialise CUDA, and GNU OpenMP
        # is not fork-safe) unless overridden
        assert "torch" in sys.modules
        from tosem_tpu_torch.runtime.runtime import _default_start_method
        assert _default_start_method() == "spawn"
        prev = os.environ.get("TOSEM_RT_START_METHOD")
        os.environ["TOSEM_RT_START_METHOD"] = "fork"
        try:
            assert _default_start_method() == "fork"
        finally:
            if prev is None:
                del os.environ["TOSEM_RT_START_METHOD"]
            else:
                os.environ["TOSEM_RT_START_METHOD"] = prev

    def test_fork_before_torch_is_loaded(self):
        code = ("import sys; "
                "from tosem_tpu_torch.runtime.runtime import "
                "_default_start_method as d; a = d(); import torch; "
                "print(a, d(), 'jax' in sys.modules)")
        env = {k: v for k, v in os.environ.items()
               if k != "TOSEM_RT_START_METHOD"}
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True, env=env,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))))
        assert out.stdout.split() == ["fork", "spawn", "False"]

    def test_running_runtime_spawns_its_workers(self, runtime):
        from tosem_tpu_torch.runtime import api
        r = api._runtime
        assert r._make_ctx().get_start_method() == "spawn"
        with r.lock:
            procs = [w.proc for w in r.task_workers]
        assert all(type(p).__name__ == "SpawnProcess" for p in procs)


class TestStoreNames:
    def test_segment_prefix_differs_from_the_jax_package(self, runtime):
        from tosem_tpu_torch.runtime import api
        from tosem_tpu_torch.runtime.runtime import STORE_PREFIX
        name = api._runtime.store_name
        assert name.startswith(STORE_PREFIX)
        assert name.startswith("/tosem_torch_rt_")
        assert not name.startswith("/tosem_rt_")

    def test_both_runtimes_live_in_one_process(self, runtime):
        """The JAX package's runtime and the port's side by side: two
        segments, no attach to each other's, each store keeps its own
        objects."""
        import tosem_tpu.runtime as jrt
        from tosem_tpu.runtime import api as japi
        from tosem_tpu_torch.runtime import api
        own = not jrt.is_initialized()
        if own:
            jrt.init(num_workers=1, memory_monitor=False)
        try:
            from tosem_tpu.runtime.object_store import ObjectID as JID
            mine, theirs = api._runtime.store, japi._runtime.store
            assert api._runtime.store_name != japi._runtime.store_name
            assert japi._runtime.store_name.startswith("/tosem_rt_")
            oid = ObjectID.random()
            mine.put(oid, b"port")
            assert mine.get(oid) == b"port"
            assert not theirs.contains(JID(oid.binary))
            data = os.urandom(1 << 20)
            assert rt.get(rt.put(data)) == data
            assert jrt.get(jrt.put(data)) == data
        finally:
            if own:
                jrt.shutdown()


class TestDuplicateDoneIdempotent:
    """Steal-path at-least-once: a second "done" for an already-completed
    task id must be dropped — never re-put into the store, never
    re-recorded in lineage — so a stolen-then-finished task cannot
    resurrect an evicted object and skew recovery determinism."""

    def _completed_store_task(self, runtime):
        from tosem_tpu_torch.runtime import api

        @rt.remote
        def big(n):
            return b"d" * n

        ref = big.remote(256 << 10)            # > INLINE_THRESHOLD → store
        assert rt.get(ref) == b"d" * (256 << 10)
        r = api._runtime
        with r.lock:
            tid, (kind, rkey) = next(reversed(r._completed.items()))
        assert kind == "store" and rkey == ref.oid.binary
        return r, ref, tid, rkey

    def test_duplicate_done_after_evict_does_not_resurrect(self, runtime):
        r, ref, tid, rkey = self._completed_store_task(runtime)
        with r.lock:
            lineage_before = r.lineage.get(rkey)
            # driver-side eviction (what chaos evict_object does)
            r.store.delete(ObjectID(rkey))
            r._evicted.add(rkey)
        assert not r.store.contains(ObjectID(rkey))
        # the stolen copy finishes later: its worker re-puts the result,
        # then its "done" reaches the driver
        r.store.put(ObjectID(rkey), b"resurrected")
        with r.lock:
            w = r.task_workers[0]
            applied = r._handle_msg_locked(w, ("done", tid, "store", rkey))
        assert applied is True
        # the duplicate neither resurrected the object nor touched lineage
        assert not r.store.contains(ObjectID(rkey))
        with r.lock:
            assert r.lineage.get(rkey) is lineage_before
        # determinism: get() heals via lineage reconstruction, exactly as
        # if the duplicate had never arrived
        assert rt.get(ref) == b"d" * (256 << 10)

    def test_duplicate_done_keeps_live_object(self, runtime):
        r, ref, tid, rkey = self._completed_store_task(runtime)
        with r.lock:
            w = r.task_workers[0]
            applied = r._handle_msg_locked(w, ("done", tid, "store", rkey))
        assert applied is True
        assert r.store.contains(ObjectID(rkey))   # live object untouched
        assert rt.get(ref) == b"d" * (256 << 10)

    def test_duplicate_inline_done_not_rerecorded(self, runtime):
        from tosem_tpu_torch.runtime import api

        @rt.remote
        def small():
            return 7

        ref = small.remote()
        assert rt.get(ref) == 7
        r = api._runtime
        with r.lock:
            tid, (kind, rkey) = next(reversed(r._completed.items()))
            assert kind == "inline"
            inline_before = r.inline.get(rkey)
            w = r.task_workers[0]
            applied = r._handle_msg_locked(
                w, ("done", tid, "inline", (0, [b"bogus"])))
        assert applied is True
        with r.lock:
            # the duplicate payload must NOT replace the recorded result
            assert r.inline.get(rkey) is inline_before
        assert rt.get(ref) == 7

    def test_duplicate_done_spares_inflight_reconstruction(self, runtime):
        """A duplicate arriving WHILE the evicted object is being healed
        must not delete the reconstruction's freshly re-put result."""
        r, ref, tid, rkey = self._completed_store_task(runtime)
        with r.lock:
            r.store.delete(ObjectID(rkey))
            r._evicted.add(rkey)
            r._reconstructing.add(rkey)        # heal in flight
        try:
            # the healing task has just re-put the object...
            r.store.put(ObjectID(rkey), b"healed")
            with r.lock:
                w = r.task_workers[0]
                # ...when the stolen copy's late duplicate lands
                r._handle_msg_locked(w, ("done", tid, "store", rkey))
            assert r.store.contains(ObjectID(rkey))  # heal survives
        finally:
            with r.lock:
                r._reconstructing.discard(rkey)
            r.store.delete(ObjectID(rkey))
            r._evicted.add(rkey)


# ---------------------------------------------------------- store lifecycle
# (tests/test_object_store_lifecycle.py)

@pytest.fixture
def store():
    s = ObjectStore(
        f"/tosem_torch_test_{os.getpid()}_{time.monotonic_ns() % 10**9}",
        capacity=4 << 20)
    yield s
    s.close()


class TestSealAbortLifecycle:
    def test_reserve_seal_readable(self, store):
        oid = ObjectID.random()
        view = store.reserve(oid, 5)
        view[:] = b"hello"
        assert store.is_sealed(oid) is False      # mid-write, unreadable
        assert not store.contains(oid)
        store.seal(oid)
        assert store.is_sealed(oid) is True
        assert store.get(oid) == b"hello"

    def test_reserve_abort_slot_gone(self, store):
        oid = ObjectID.random()
        store.reserve(oid, 8)
        store.abort(oid)
        assert store.is_sealed(oid) is None       # absent
        assert store.get(oid) is None
        # the id is reusable after an abort
        store.put(oid, b"take2")
        assert store.get(oid) == b"take2"

    def test_double_seal_and_seal_absent(self, store):
        oid = ObjectID.random()
        store.reserve(oid, 3)
        store.seal(oid)
        with pytest.raises(ObjectStoreError):
            store.seal(oid)                       # already sealed
        with pytest.raises(ObjectStoreError):
            store.seal(ObjectID.random())         # never reserved

    def test_oversized_put_leaves_no_slot(self, store):
        oid = ObjectID.random()
        with pytest.raises(ObjectStoreError):
            store.put_parts(oid, [b"x" * (8 << 20)])   # > 4MB capacity
        # the failed write must not leave a stuck mid-write slot
        assert store.is_sealed(oid) is None


class TestReclaimOrphan:
    def test_reclaim_requires_dead_creator(self, store):
        oid = ObjectID.random()
        store.reserve(oid, 4)
        # creator (this process) is alive: refuse to reclaim
        assert store.reclaim_orphan(oid) is False
        store.abort(oid)

    def test_reclaim_not_midwrite(self, store):
        oid = ObjectID.random()
        store.put(oid, b"sealed")
        assert store.reclaim_orphan(oid) is False   # sealed, not orphaned
        assert store.reclaim_orphan(ObjectID.random()) is False  # absent

    def test_reclaim_after_creator_death(self, store):
        """A child process reserves a slot and dies mid-write; the
        parent reclaims the orphaned slot and can rewrite the id."""
        oid = ObjectID.random()
        code = (
            "import sys\n"
            "sys.path.insert(0, %r)\n"
            "from tosem_tpu_torch.runtime.object_store import ObjectID, ObjectStore\n"
            "s = ObjectStore(%r, create=False)\n"
            "s.reserve(ObjectID(bytes.fromhex(%r)), 16)\n"
            "import os; os._exit(9)\n"   # die WITHOUT abort/seal
        ) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             store.name, oid.hex())
        subprocess.run([sys.executable, "-c", code], check=False, timeout=60)
        assert store.is_sealed(oid) is False        # orphaned mid-write
        assert store.reclaim_orphan(oid) is True
        store.put(oid, b"rewritten")
        assert store.get(oid) == b"rewritten"


class TestSpillTier:
    def test_spill_and_transparent_restore(self, store):
        oid = ObjectID.random()
        store.put(oid, b"z" * 10_000)
        assert store.spill(oid) is True
        assert not store.contains_shm(oid)
        assert store.has_spilled(oid)
        assert store.contains(oid)                # spilled counts as present
        # get transparently restores (and promotes back into shm)
        assert store.get(oid) == b"z" * 10_000
        assert store.contains_shm(oid)
        assert not store.has_spilled(oid)         # promoted, file cleaned

    def test_spill_absent_is_false(self, store):
        assert store.spill(ObjectID.random()) is False

    def test_spill_idempotent(self, store):
        oid = ObjectID.random()
        store.put(oid, b"q" * 100)
        assert store.spill(oid)
        assert store.spill(oid) is True           # already spilled = success

    def test_delete_removes_spill_file_too(self, store):
        oid = ObjectID.random()
        store.put(oid, b"gone" * 50)
        store.spill(oid)
        store.delete(oid)
        assert not store.has_spilled(oid)
        assert store.get(oid) is None             # truly gone

    def test_spilled_ids_listing(self, store):
        oid = ObjectID.random()
        store.put(oid, b"listme" * 10)
        store.spill(oid)
        assert oid.hex() in store.spilled_ids()
        assert all(len(h) == 2 * ID_LEN for h in store.spilled_ids())

    def test_spill_streams_multi_chunk_object_bit_identical(self, store):
        """An object larger than SPILL_CHUNK is streamed to the file in
        slices (no whole-object heap copy under pressure) and restores
        bit-identically."""
        from tosem_tpu_torch.runtime.object_store import SPILL_CHUNK
        payload = bytes(range(256)) * ((2 * SPILL_CHUNK) // 256 + 1)
        oid = ObjectID.random()
        store.put(oid, payload)
        assert store.spill(oid) is True
        assert os.path.getsize(store._spill_path(oid)) == len(payload)
        assert store.get(oid) == payload
