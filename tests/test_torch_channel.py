"""Cross-host channel QoS (cluster/channel.py): the Cyber transport
reliability tiers ACROSS processes — reliable delivers everything,
best_effort KEEP_LASTs under pressure — plus cross-host record/replay
(cyber_recorder record/play over the wire).

A copy of ``tests/test_channel.py`` against the port's
``cluster/channel.py`` (with its copy of ``ChannelQos``) and
``cluster/replay.py``; the last test holds the port's QoS profile to the
JAX package's.
"""
import os
import subprocess
import sys
import textwrap

from tosem_tpu_torch.cluster.channel import (ChannelBroker,
                                             ChannelPublisher, ChannelQos,
                                             ChannelSubscriber,
                                             replay_publish)
from tosem_tpu_torch.cluster.replay import Recorder, replay_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _publish_from_subprocess(address: str, channel: str, n: int) -> None:
    """A REAL second process publishes — the cross-host half."""
    code = textwrap.dedent(f"""
        from tosem_tpu_torch.cluster.channel import ChannelPublisher
        pub = ChannelPublisher({address!r}, {channel!r})
        for i in range({n}):
            pub.publish({{"frame": i}})
        pub.close()
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


class TestQosAcrossProcesses:
    def test_reliable_delivers_every_message(self):
        broker = ChannelBroker()
        try:
            sub = ChannelSubscriber(broker.address, "lidar",
                                    qos=ChannelQos(depth=1,
                                                   reliability="reliable"))
            _publish_from_subprocess(broker.address, "lidar", 10)
            msgs = sub.take(max_n=64)
            assert [p["frame"] for _, p in msgs] == list(range(10))
            assert [s for s, _ in msgs] == list(range(1, 11))
            assert sub.dropped == 0
            sub.close()
        finally:
            broker.shutdown()

    def test_best_effort_keeps_last_depth(self):
        """KEEP_LAST: a slow reader sees only the FRESHEST ``depth``
        frames; the drop count makes the eviction observable."""
        broker = ChannelBroker()
        try:
            sub = ChannelSubscriber(
                broker.address, "lidar",
                qos=ChannelQos(depth=3, reliability="best_effort"))
            _publish_from_subprocess(broker.address, "lidar", 10)
            msgs = sub.take()
            assert [p["frame"] for _, p in msgs] == [7, 8, 9]  # freshest
            assert sub.dropped == 7
            sub.close()
        finally:
            broker.shutdown()

    def test_tiers_differ_on_the_same_burst(self):
        broker = ChannelBroker()
        try:
            rel = ChannelSubscriber(broker.address, "cam",
                                    qos=ChannelQos(reliability="reliable"))
            be = ChannelSubscriber(
                broker.address, "cam",
                qos=ChannelQos(depth=1, reliability="best_effort"))
            _publish_from_subprocess(broker.address, "cam", 5)
            assert len(rel.take()) == 5
            assert [p["frame"] for _, p in be.take()] == [4]
            rel.close(); be.close()
        finally:
            broker.shutdown()

    def test_late_subscriber_sees_only_future(self):
        broker = ChannelBroker()
        try:
            pub = ChannelPublisher(broker.address, "cam")
            pub.publish({"frame": -1})
            sub = ChannelSubscriber(broker.address, "cam")
            pub.publish({"frame": 0})
            assert [p["frame"] for _, p in sub.take()] == [0]
            pub.close(); sub.close()
        finally:
            broker.shutdown()


class TestCrossHostRecordReplay:
    def test_record_then_replay_through_live_channel(self, tmp_path):
        rec_path = str(tmp_path / "drive.db")
        broker = ChannelBroker()
        try:
            # leg 1: a second process publishes; we tap into a Recorder
            tap = ChannelSubscriber(broker.address, "tracks",
                                    qos=ChannelQos(reliability="reliable"))
            _publish_from_subprocess(broker.address, "tracks", 6)
            rec = Recorder(rec_path)
            assert tap.record_into(rec, max_n=64) == 6
            rec.close()
            tap.close()

            # leg 2: replay the recording through a LIVE channel; a
            # fresh subscriber receives the original stream
            sub2 = ChannelSubscriber(broker.address, "tracks_replay")
            pub2 = ChannelPublisher(broker.address, "tracks_replay")
            n = replay_publish(rec_path, "tracks", pub2)
            assert n == 6
            assert [p["frame"] for _, p in sub2.take()] == list(range(6))
            pub2.close(); sub2.close()
        finally:
            broker.shutdown()
        # and the recording itself doubles as a dataflow source
        assert [m["frame"] for m in replay_source(rec_path, "tracks")] \
            == list(range(6))


def test_qos_profile_is_the_reference_s():
    """The port's ChannelQos is the JAX package's: same fields, same
    defaults, the same values refused."""
    import dataclasses

    import pytest

    from tosem_tpu.dataflow.components import ChannelQos as RefQos
    assert ([(f.name, f.default) for f in dataclasses.fields(ChannelQos)]
            == [(f.name, f.default) for f in dataclasses.fields(RefQos)])
    for bad in (dict(depth=0), dict(reliability="lossy")):
        with pytest.raises(ValueError):
            ChannelQos(**bad)
        with pytest.raises(ValueError):
            RefQos(**bad)
