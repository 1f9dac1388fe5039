"""Cross-host channels — pub/sub with QoS over the RPC control plane.

The reference's Cyber transport carries channels BETWEEN hosts over
RTPS/DDS with per-channel QoS (``cyber/transport/rtps/participant.cc``,
``cyber/transport/qos/qos_profile_conf.cc``: history depth +
reliability tier negotiated per reader). In-process we already have
those semantics on the deterministic runtime
(:class:`~tosem_tpu_torch.dataflow.components.ChannelQos`); this module
extends the SAME profile across processes/hosts:

- :class:`ChannelBroker` — a host-side hub (the DDS participant role)
  holding one bounded or unbounded queue PER SUBSCRIBER: ``reliable``
  queues deliver every message; ``best_effort`` queues KEEP_LAST
  ``depth`` — under write pressure the OLDEST undelivered message is
  dropped (fresher sensor frame supersedes stale), exactly the
  in-process tier semantics. Sequence numbers make drops observable.
- :class:`ChannelPublisher` / :class:`ChannelSubscriber` — driver-side
  endpoints over :class:`~tosem_tpu_torch.cluster.rpc.RpcClient`
  (pull-based take(): the subscriber's poll cadence is its deadline —
  no server-push thread to leak).
- record/replay integration: :meth:`ChannelSubscriber.record_into`
  taps a cross-host channel into a
  :class:`~tosem_tpu_torch.cluster.replay.Recorder`, and
  :func:`replay_publish` re-drives a recording through a publisher with
  the original timing — ``cyber_recorder record/play`` across hosts.

Transport note: rides the same loopback/private-interconnect-only RPC
as the rest of the control plane (`cluster/rpc.py` refuses public
binds); for DCN-scale deployments the broker sits next to the data
producer and subscribers tunnel in.

A copy of the JAX package's ``cluster/channel.py``.
"""
from __future__ import annotations

import collections
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

from tosem_tpu_torch.cluster.rpc import RpcClient, RpcServer
from tosem_tpu_torch.dataflow.components import ChannelQos

__all__ = ["ChannelBroker", "ChannelPublisher", "ChannelSubscriber",
           "ChannelQos", "replay_publish"]


class _BrokerHandlers:
    """RPC surface: subscribe / unsubscribe / publish / take."""

    def __init__(self):
        self._lock = threading.Lock()
        # (channel, sub_id) → {"q": deque, "reliability": str,
        #                      "dropped": int}
        self._subs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._seq: Dict[str, int] = {}

    def subscribe(self, channel: str, sub_id: str, depth: int,
                  reliability: str) -> None:
        qos = ChannelQos(depth=depth, reliability=reliability)  # validates
        with self._lock:
            maxlen = qos.depth if qos.reliability == "best_effort" else None
            self._subs[(channel, sub_id)] = {
                "q": collections.deque(maxlen=maxlen),
                "reliability": qos.reliability, "dropped": 0}

    def unsubscribe(self, channel: str, sub_id: str) -> None:
        with self._lock:
            self._subs.pop((channel, sub_id), None)

    def publish(self, channel: str, payload: Any) -> int:
        """Fan out to every subscriber queue; returns the sequence
        number. A full best_effort queue drops its OLDEST entry
        (KEEP_LAST) and counts the drop."""
        with self._lock:
            seq = self._seq.get(channel, 0) + 1
            self._seq[channel] = seq
            for (ch, _sid), sub in self._subs.items():
                if ch != channel:
                    continue
                q = sub["q"]
                if q.maxlen is not None and len(q) == q.maxlen:
                    sub["dropped"] += 1      # deque evicts the oldest
                q.append((seq, payload))
            return seq

    def take(self, channel: str, sub_id: str,
             max_n: int = 64) -> Dict[str, Any]:
        """Drain up to ``max_n`` pending messages for one subscriber."""
        with self._lock:
            sub = self._subs.get((channel, sub_id))
            if sub is None:
                raise KeyError(
                    f"no subscription {sub_id!r} on {channel!r}")
            out = []
            while sub["q"] and len(out) < max_n:
                out.append(sub["q"].popleft())
            return {"messages": out, "dropped": sub["dropped"]}

    def channels(self) -> List[str]:
        with self._lock:
            return sorted(self._seq)


class ChannelBroker:
    """Host-side hub: an RpcServer owning the subscriber queues."""

    def __init__(self, port: int = 0):
        self._handlers = _BrokerHandlers()
        self._server = RpcServer(self._handlers, port=port)
        self.address = self._server.address

    def shutdown(self) -> None:
        self._server.shutdown()


class ChannelPublisher:
    """Remote writer endpoint for one channel."""

    def __init__(self, broker_address: str, channel: str,
                 timeout: float = 30.0):
        self._client = RpcClient(broker_address, timeout=timeout)
        self.channel = channel

    def publish(self, payload: Any) -> int:
        return int(self._client.call("publish", self.channel, payload))

    def close(self) -> None:
        self._client.close()


class ChannelSubscriber:
    """Remote reader endpoint: pull-based take() with QoS decided at
    subscribe time (the DDS reader-side profile)."""

    def __init__(self, broker_address: str, channel: str,
                 qos: ChannelQos = ChannelQos(),
                 sub_id: Optional[str] = None, timeout: float = 30.0):
        self._client = RpcClient(broker_address, timeout=timeout)
        self.channel = channel
        self.sub_id = sub_id or uuid.uuid4().hex[:12]
        self.qos = qos
        self.dropped = 0
        self._client.call("subscribe", channel, self.sub_id, qos.depth,
                          qos.reliability)

    def take(self, max_n: int = 64) -> List[Tuple[int, Any]]:
        """Pending (seq, payload) pairs; updates :attr:`dropped` with
        the broker-side KEEP_LAST drop count."""
        out = self._client.call("take", self.channel, self.sub_id, max_n)
        self.dropped = int(out["dropped"])
        return [(int(s), p) for s, p in out["messages"]]

    def record_into(self, recorder, topic: Optional[str] = None,
                    max_n: int = 256) -> int:
        """Drain pending messages into a Recorder (cross-host
        ``cyber_recorder record``). Returns how many were written."""
        msgs = self.take(max_n)
        for _seq, payload in msgs:
            recorder.write(topic or self.channel, payload)
        return len(msgs)

    def close(self) -> None:
        try:
            self._client.call("unsubscribe", self.channel, self.sub_id)
        finally:
            self._client.close()


def replay_publish(path: str, topic: str, publisher: ChannelPublisher,
                   *, realtime: bool = False, speed: float = 1.0) -> int:
    """Re-drive a recorded topic through a live cross-host channel with
    the original inter-message timing (``cyber_recorder play``).
    Returns the number of messages published."""
    from tosem_tpu_torch.cluster.replay import replay
    n = 0
    for _top, _t, msg in replay(path, topic, realtime=realtime,
                                speed=speed):
        publisher.publish(msg)
        n += 1
    return n
