"""Example trainables for the experiment CLI (the ``nni/examples/trials``
role: self-contained targets a spec file can reference by import path).

The port's copy of ``tosem_tpu/tune/examples.py``: refs read
``tosem_tpu_torch.tune.examples:<name>``."""
from __future__ import annotations


def quadratic(config):
    """Converging quadratic: loss = (x - 2)^2 shrunk each iteration by a
    config-controlled rate — exercises schedulers (early iterations are
    informative) without touching a device."""
    x = float(config.get("x", 0.0))
    lr = float(config.get("lr", 0.1))
    loss = (x - 2.0) ** 2 + 1e-3
    for _ in range(1000):
        loss *= (1.0 - min(lr, 0.9) * 0.5)
        yield {"loss": loss}


def always_crashes(config):
    """Deliberately failing trainable (failure-path tests)."""
    raise RuntimeError("synthetic trial failure")
    yield  # pragma: no cover — makes this a generator function


class counting(object):
    """Class trainable whose state is its step counter (the minimal
    ``save_state``/``load_state`` contract) — the crash-resume target:
    a resumed run continues its iteration count, a restarted one
    starts over, so the reported ``training_iteration`` sequence tells
    the two apart. Duck-typed to the :class:`tosem_tpu_torch.tune.tune
    .Trainable` surface without importing the runtime stack (this
    module must stay importable in bare trial-worker subprocesses)."""

    def __init__(self, config):
        self.config = dict(config)
        self.n = 0
        self.x = float(self.config.get("x", 1.0))

    def step(self):
        import os
        self.n += 1
        # pid makes resume observable from the metric history alone: a
        # resumed trial's entries span two processes, a restarted one's
        # only the latest (crash-resume tests key on this)
        return {"loss": self.x / self.n, "n": self.n, "pid": os.getpid()}

    def save_state(self):
        return self.n

    def load_state(self, state):
        self.n = int(state)

    def reset_config(self, config):
        self.config = dict(config)


def noisy_branin(config):
    """2-D Branin-like surface for searcher comparisons."""
    import math
    x = float(config.get("x", 0.0))
    y = float(config.get("y", 0.0))
    val = ((y - 0.1 * x * x + x - 6.0) ** 2
           + 10.0 * (1 - 1 / (8 * math.pi)) * math.cos(x) + 10.0)
    while True:
        yield {"loss": val}
