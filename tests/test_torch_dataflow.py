"""The port's dataflow engine (``tosem_tpu_torch/dataflow/``), held to the
JAX package's own tests and to the JAX package itself.

Copies, against :mod:`tosem_tpu_torch.dataflow`, of
``tests/test_dataflow.py``'s six ``StreamGraph`` tests (on the port's
actor runtime) and of the component, QoS and coroutine tests of
``tests/test_components_dashboard.py`` (``TestComponents``,
``TestChannelQos``, ``TestCoroutineComponent``). The last tests run one
script of writes through both packages' ``ComponentRuntime`` and hold
the deliveries, the histories and the drop counts equal, and
``ChannelQos``'s validation to the JAX package's.

The stream graph's operators are defined here and run in spawned
workers, so this module ships them by value
(``cloudpickle.register_pickle_by_value``).
"""
import sys

import cloudpickle
import pytest

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.dataflow import (Component, ComponentRuntime,
                                      TimerComponent)

cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def shared_runtime():
    own = not rt.is_initialized()
    if own:
        rt.init(num_workers=3)
    yield
    if own:
        rt.shutdown()


# ---------------------------------------------------------- components

class Fuser(Component):
    def __init__(self):
        super().__init__("fuser", ["lidar", "camera"])
        self.calls = []

    def proc(self, lidar, camera=None):
        self.calls.append((lidar, camera))


class Ticker(TimerComponent):
    def __init__(self, interval=0.1):
        super().__init__("ticker", interval)
        self.fired = []

    def on_init(self, ctx):
        self.ctx = ctx

    def proc(self):
        self.fired.append(self.ctx.now)


class TestComponents:
    def test_fused_readers_primary_drives(self):
        rtc = ComponentRuntime()
        f = Fuser()
        rtc.add(f)
        lidar_w = rtc.writer("lidar")
        cam_w = rtc.writer("camera")
        lidar_w("L1")                     # no camera yet → fused None
        cam_w("C1")                       # secondary alone: no proc
        lidar_w("L2")                     # fuses latest camera
        rtc.run_until(1.0)
        assert f.calls == [("L1", None), ("L2", "C1")]

    def test_timer_component_fires_on_schedule(self):
        rtc = ComponentRuntime()
        t = Ticker(interval=0.25)
        rtc.add(t)
        rtc.run_until(1.0)
        assert t.fired == pytest.approx([0.25, 0.5, 0.75, 1.0])
        rtc.run_until(1.5)                # continues across calls
        assert len(t.fired) == 6

    def test_event_ordering_deterministic_with_latency(self):
        rtc = ComponentRuntime()
        f = Fuser()
        rtc.add(f)
        lidar_w = rtc.writer("lidar")
        cam_w = rtc.writer("camera")
        cam_w("C-late", latency=0.5)
        lidar_w("L-early", latency=0.1)
        lidar_w("L-late", latency=0.9)
        rtc.run_until(2.0)
        assert f.calls == [("L-early", None), ("L-late", "C-late")]

    def test_clock_rewind_rejected(self):
        rtc = ComponentRuntime()
        rtc.run_until(1.0)
        with pytest.raises(ValueError):
            rtc.run_until(0.5)

    def test_channels_discoverable(self):
        rtc = ComponentRuntime()
        rtc.add(Fuser())
        rtc.writer("radar")
        assert set(rtc.channels()) >= {"lidar", "camera", "radar"}

    def test_timer_pipeline_feeds_component(self):
        rtc = ComponentRuntime()

        class Source(TimerComponent):
            def __init__(self):
                super().__init__("src", 0.2)
                self.n = 0

            def on_init(self, ctx):
                self.write = ctx.writer("lidar")

            def proc(self):
                self.n += 1
                self.write(f"scan{self.n}")

        f = Fuser()
        rtc.add(f)
        rtc.add(Source())
        rtc.run_until(1.0)
        assert [c[0] for c in f.calls] == ["scan1", "scan2", "scan3",
                                           "scan4", "scan5"]
        assert rtc.proc_counts()["fuser"] == 5



@pytest.mark.usefixtures("shared_runtime")
class TestStreamGraph:
    def test_linear_pipeline_wordcount_style(self):
        from tosem_tpu_torch.dataflow import StreamGraph, keyed

        class Counter:
            def __init__(self):
                self.counts = {}

            def process(self, word):
                self.counts[word] = self.counts.get(word, 0) + 1
                return None            # emit only at end-of-stream

            def flush(self):
                return [self.counts]

        g = StreamGraph()
        src = g.source("text", ["a b a", "c b a", "c c c"])
        split = g.stage("split", lambda line: line.split(), parallelism=2)
        count = g.stage("count", Counter,
                        partitioning=keyed(lambda w: w))
        out = g.sink("out")
        g.connect(src, split)
        g.connect(split, count)
        g.connect(count, out)
        results = g.run()["out"]
        total = {}
        for d in results:
            for k, v in d.items():
                total[k] = total.get(k, 0) + v
        assert total == {"a": 3, "b": 2, "c": 4}

    def test_keyed_partitioning_preserves_per_key_instance(self):
        from tosem_tpu_torch.dataflow import StreamGraph, keyed

        class Tagger:
            def __init__(self):
                self.seen = set()

            def process(self, item):
                self.seen.add(item[0])
                return None

            def flush(self):
                return [sorted(self.seen)]

        g = StreamGraph()
        items = [(k, i) for i in range(5) for k in ("x", "y", "z", "w")]
        src = g.source("s", items)
        tag = g.stage("tag", Tagger, parallelism=2,
                      partitioning=keyed(lambda kv: kv[0]))
        out = g.sink("o")
        g.connect(src, tag)
        g.connect(tag, out)
        per_instance = g.run()["o"]
        # each key lands on exactly one instance
        assert len(per_instance) == 2
        assert sorted(sum(per_instance, [])) == ["w", "x", "y", "z"]

    def test_fanout_list_and_filter_none(self):
        from tosem_tpu_torch.dataflow import StreamGraph
        g = StreamGraph()
        src = g.source("n", range(6))
        expand = g.stage("expand", lambda x: [x, x] if x % 2 == 0 else None)
        out = g.sink("o")
        g.connect(src, expand)
        g.connect(expand, out)
        res = sorted(g.run()["o"])
        assert res == [0, 0, 2, 2, 4, 4]

    def test_operator_exception_fails_run(self):
        from tosem_tpu_torch.dataflow import StreamGraph
        g = StreamGraph()
        src = g.source("n", range(4))
        bad = g.stage("bad", lambda x: 1 / (x - 2))
        out = g.sink("o")
        g.connect(src, bad)
        g.connect(bad, out)
        with pytest.raises(Exception):
            g.run()

    def test_cycle_detection(self):
        from tosem_tpu_torch.dataflow import StreamGraph
        g = StreamGraph()
        a = g.stage("a", lambda x: x)
        b = g.stage("b", lambda x: x)
        g.connect(a, b)
        g.connect(b, a)
        with pytest.raises(ValueError):
            g.run()

    def test_broadcast_partitioning(self):
        from tosem_tpu_torch.dataflow import StreamGraph, broadcast

        class Collect:
            def __init__(self):
                self.n = 0

            def process(self, item):
                self.n += 1
                return None

            def flush(self):
                return [self.n]

        g = StreamGraph()
        src = g.source("s", range(7))
        c = g.stage("c", Collect, parallelism=3,
                    partitioning=broadcast())
        out = g.sink("o")
        g.connect(src, c)
        g.connect(c, out)
        counts = g.run()["o"]
        assert counts == [7, 7, 7]


class TestChannelQos:
    """QoS tiers on component channels (cyber QosProfile: history depth
    + reliability; best_effort = KEEP_LAST sensor-stream semantics)."""

    def _rt_and_sink(self, qos=None):
        from tosem_tpu_torch.dataflow import (ChannelQos, Component,
                                        ComponentRuntime)
        rt = ComponentRuntime()
        got = []

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["ch"])

            def proc(self, msg):
                got.append(msg)

        rt.add(Sink())
        w = rt.writer("ch", qos=qos)
        return rt, w, got

    def test_reliable_delivers_everything(self):
        rt, w, got = self._rt_and_sink()
        for i in range(5):
            w(i, latency=0.1)
        rt.run_until(1.0)
        assert got == [0, 1, 2, 3, 4]
        assert rt.drop_counts() == {}

    def test_best_effort_keeps_last_depth(self):
        from tosem_tpu_torch.dataflow import ChannelQos
        rt, w, got = self._rt_and_sink(
            ChannelQos(depth=2, reliability="best_effort"))
        for i in range(5):          # 5 writes before any delivery fires
            w(i, latency=0.5)
        rt.run_until(1.0)
        assert got == [3, 4]        # oldest three superseded
        assert rt.drop_counts()["ch"] == 3

    def test_history_buffer_depth(self):
        from tosem_tpu_torch.dataflow import ChannelQos
        rt, w, got = self._rt_and_sink(ChannelQos(depth=3))
        for i in range(6):
            w(i, latency=0.01 * (i + 1))
        rt.run_until(1.0)
        assert got == list(range(6))          # reliable: no drops
        assert rt.history("ch") == [3, 4, 5]  # last depth=3, oldest first

    def test_qos_validation(self):
        from tosem_tpu_torch.dataflow import ChannelQos
        import pytest as _pytest
        with _pytest.raises(ValueError):
            ChannelQos(depth=0)
        with _pytest.raises(ValueError):
            ChannelQos(reliability="sometimes")

    def test_best_effort_messages_keep_own_latency(self):
        """Regression: each surviving best-effort message arrives at ITS
        modeled latency — a later short-latency write must not smuggle an
        earlier message in ahead of its transport time."""
        from tosem_tpu_torch.dataflow import ChannelQos
        rt, w, got = self._rt_and_sink(
            ChannelQos(depth=2, reliability="best_effort"))
        w("slow", latency=10.0)
        w("fast", latency=0.1)
        rt.run_until(1.0)
        assert got == ["fast"]          # slow hasn't arrived yet
        rt.run_until(20.0)
        assert got == ["fast", "slow"]  # and arrives at its own time

    def test_best_effort_depth_shrink_trims_backlog(self):
        """Regression: re-pinning a smaller depth trims the whole
        over-depth backlog, not one message per subsequent write."""
        from tosem_tpu_torch.dataflow import ChannelQos
        rt, w, got = self._rt_and_sink(
            ChannelQos(depth=5, reliability="best_effort"))
        for i in range(5):
            w(i, latency=1.0)
        w2 = rt.writer("ch", qos=ChannelQos(depth=1,
                                            reliability="best_effort"))
        w2(99, latency=1.0)
        rt.run_until(2.0)
        assert got == [99]
        assert rt.drop_counts()["ch"] == 5


class TestCoroutineComponent:
    """Croutine-lite: generator routines with data_wait/sleep yields on
    the deterministic virtual-time loop (cyber/croutine role)."""

    def _run(self):
        from tosem_tpu_torch.dataflow import (ComponentRuntime,
                                              CoroutineComponent)
        rt = ComponentRuntime()
        log = []

        class Fuser(CoroutineComponent):
            def run(self, ctx):
                out = ctx.writer("fused")
                yield ("sleep", 0.5)            # virtual-time park
                log.append(("awake", ctx.now))
                for _ in range(3):              # data_wait three times
                    msg = yield "sensor"
                    log.append(("got", msg, ctx.now))
                    out(msg * 10)
                log.append(("done", ctx.now))

        rt.add(Fuser("fuser"))
        w = rt.writer("sensor")
        got = []
        from tosem_tpu_torch.dataflow import Component

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["fused"])

            def proc(self, m):
                got.append(m)

        rt.add(Sink())
        for i in range(4):                      # 4th arrives after retire
            w(i + 1, latency=1.0 + i)
        rt.run_until(10.0)
        return log, got, rt

    def test_data_wait_and_sleep_semantics(self):
        log, got, rt = self._run()
        assert log[0] == ("awake", 0.5)
        assert [e[1] for e in log if e[0] == "got"] == [1, 2, 3]
        assert [e[2] for e in log if e[0] == "got"] == [1.0, 2.0, 3.0]
        assert got == [10, 20, 30]              # retired before msg 4
        assert log[-1][0] == "done"
        assert rt._waiters == {}                # nothing left parked

    def test_deterministic_across_runs(self):
        a = self._run()[0]
        b = self._run()[0]
        assert a == b

    def test_bad_yield_raises(self):
        from tosem_tpu_torch.dataflow import (ComponentRuntime,
                                              CoroutineComponent)
        rt = ComponentRuntime()

        class Bad(CoroutineComponent):
            def run(self, ctx):
                yield 42

        rt.add(Bad("bad"))
        import pytest as _p
        with _p.raises(TypeError):
            rt.run_until(1.0)

    def test_same_timestamp_burst_is_lossless(self):
        """Regression (confirmed repro pre-fix): two messages delivered
        at the SAME virtual time must both reach a data_wait loop; the
        waiter mailbox buffers resume-in-flight deliveries."""
        from tosem_tpu_torch.dataflow import (ComponentRuntime,
                                              CoroutineComponent)
        rt = ComponentRuntime()
        got = []

        class Two(CoroutineComponent):
            def run(self, ctx):
                for _ in range(2):
                    got.append((yield "sensor"))

        rt.add(Two("two"))
        w = rt.writer("sensor")
        w(1, latency=1.0)
        w(2, latency=1.0)            # same arrival instant
        rt.run_until(2.0)
        assert got == [1, 2]
        assert rt._waiters.get("sensor", []) == []   # retired, not stuck


# ------------------------------------------------- against the JAX package

# (op, args): writes at a latency, a QoS pinned by a second writer, and
# clock steps, the same in both packages
QOS_SCRIPTS = {
    "reliable_latencies": [("writer", None), ("w", 0, 0.3), ("w", 1, 0.1),
                           ("w", 2, 0.2), ("run", 1.0)],
    "best_effort_burst": [("writer", (2, "best_effort")),
                          *[("w", i, 0.5) for i in range(6)],
                          ("run", 1.0), ("w", 9, 0.1), ("run", 2.0)],
    "own_latency": [("writer", (2, "best_effort")), ("w", "slow", 10.0),
                    ("w", "fast", 0.1), ("run", 1.0), ("run", 20.0)],
    "depth_shrink": [("writer", (5, "best_effort")),
                     *[("w", i, 1.0) for i in range(5)],
                     ("writer", (1, "best_effort")), ("w", 99, 1.0),
                     ("run", 2.0)],
    "history": [("writer", (3, "reliable")),
                *[("w", i, 0.01 * (i + 1)) for i in range(6)],
                ("run", 1.0)],
}


def _run_script(dataflow, script):
    """Deliveries, history, drop counts and proc counts of ``script``
    on ``dataflow``'s ComponentRuntime."""
    rtc = dataflow.ComponentRuntime()
    got = []

    class Sink(dataflow.Component):
        def __init__(self):
            super().__init__("sink", ["ch"])

        def proc(self, msg):
            got.append((rtc.now, msg))

    rtc.add(Sink())
    w = None
    for op, *args in script:
        if op == "writer":
            qos = None if args[0] is None else dataflow.ChannelQos(
                depth=args[0][0], reliability=args[0][1])
            w = rtc.writer("ch", qos=qos)
        elif op == "w":
            w(args[0], latency=args[1])
        else:
            rtc.run_until(args[0])
    return {"got": got, "history": rtc.history("ch"),
            "drops": rtc.drop_counts(), "procs": rtc.proc_counts(),
            "channels": sorted(rtc.channels())}


@pytest.mark.parametrize("name", sorted(QOS_SCRIPTS))
def test_qos_script_matches_the_jax_package(name):
    import tosem_tpu.dataflow as jdf
    import tosem_tpu_torch.dataflow as tdf
    ours = _run_script(tdf, QOS_SCRIPTS[name])
    assert ours == _run_script(jdf, QOS_SCRIPTS[name])
    assert ours["got"]                 # the script delivered something


@pytest.mark.parametrize("kw", [{"depth": 0}, {"depth": -3},
                                {"reliability": "sometimes"},
                                {"depth": 1}, {"depth": 7,
                                               "reliability": "best_effort"}])
def test_qos_validation_matches_the_jax_package(kw):
    from tosem_tpu.dataflow import ChannelQos as JaxQos
    from tosem_tpu_torch.cluster.channel import ChannelQos as ChannelCopy
    from tosem_tpu_torch.dataflow import ChannelQos
    assert ChannelCopy is ChannelQos   # the channel's profile is this one

    def outcome(cls):
        try:
            q = cls(**kw)
        except ValueError as e:
            return ("raises", str(e))
        return ("ok", q.depth, q.reliability)
    assert outcome(ChannelQos) == outcome(JaxQos)
