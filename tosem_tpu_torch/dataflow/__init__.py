"""Streaming dataflow / component-DAG engine on the actor runtime.

Apollo Cyber's component model — callbacks wired by typed channels under
a scheduler (``cyber/component/component.h:58-136``) — and Ray
Streaming's stage dataflow with credit-based backpressure
(``streaming/src/data_writer.cc``). Stages are runtime actors (stateful,
restartable) or stateless task fans; the driver owns routing, credits,
and end-of-stream propagation.

The port's copy of the JAX package's ``dataflow/``: host code on the
port's runtime (:mod:`tosem_tpu_torch.runtime`) and discovery registry.
"""
from tosem_tpu_torch.dataflow.components import (ChannelQos, Component,
                                                 ComponentContext,
                                                 ComponentRuntime,
                                                 CoroutineComponent,
                                                 TimerComponent)
from tosem_tpu_torch.dataflow.graph import (Stage, StreamGraph, broadcast,
                                            keyed, rebalance)

__all__ = ["StreamGraph", "Stage", "keyed", "rebalance", "broadcast",
           "Component", "TimerComponent", "ComponentRuntime",
           "ComponentContext", "ChannelQos", "CoroutineComponent"]
