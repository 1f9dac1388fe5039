"""The port's preemption-safe checkpoints and ``fit`` (counterparts of
``tests/test_train_checkpoint.py``): atomic writes with checksum
manifests whose schema and file names equal the JAX package's, last-K
retention, torn and corrupt checkpoints skipped or refused, the async
writer, and a resumed ``fit`` whose metric history is bit-exact, after a
plain stop, a preemption through the port's chaos hook, and with dropout
on a tiny BERT."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _ckpt():
    from tosem_tpu_torch.train import checkpoint
    return checkpoint


def _tree():
    return {"a": torch.arange(4, dtype=torch.float32),
            "b": {"c": torch.ones(2, 2)}}


def _template():
    return {"a": torch.zeros(4), "b": {"c": torch.zeros(2, 2)}}


def _corrupt_one_file(path):
    """Flip a byte in some data file under a checkpoint dir."""
    for root, _, names in os.walk(path):
        for n in sorted(names):
            fp = os.path.join(root, n)
            if n != _ckpt().MANIFEST and os.path.getsize(fp) > 0:
                with open(fp, "r+b") as f:
                    b = f.read()
                    f.seek(0)
                    f.write(bytes([b[0] ^ 0xFF]) + b[1:])
                return fp
    raise AssertionError("no file to corrupt")


class _Preempt:
    """A chaos controller that preempts training after step ``at``."""

    def __init__(self, at):
        self.at = at

    def on(self, site, **ctx):
        if site == "train.step" and ctx.get("step") == self.at:
            return {"action": "preempt"}
        return None


class _chaos:
    def __init__(self, controller):
        self.controller = controller

    def __enter__(self):
        from tosem_tpu_torch.chaos import install
        install(self.controller)

    def __exit__(self, *exc):
        from tosem_tpu_torch.chaos import uninstall
        uninstall()


# ------------------------------------------------------- atomic writes


def test_save_restore_with_extra(tmp_path):
    ck = _ckpt()
    p = str(tmp_path / "ck")
    ck.save_checkpoint(p, _tree(), extra={"history": [1.5, 2.5]})
    out = ck.restore_checkpoint(p, _template())
    assert torch.equal(out["a"], _tree()["a"])
    assert torch.equal(out["b"]["c"], _tree()["b"]["c"])
    assert ck.load_extra(p) == {"history": [1.5, 2.5]}
    assert os.listdir(tmp_path) == ["ck"]         # no staging left over


def test_manifest_schema_and_names_equal_the_reference(tmp_path):
    """Both packages write ``_tosem_manifest.json`` as ``{"version": 1,
    "files": {relpath: sha256}}`` beside ``_tosem_extra.json``, under
    ``ckpt_<step:08d>`` version names."""
    import jax.numpy as jnp
    from tosem_tpu.train import checkpoint as ref
    ck = _ckpt()
    assert (ck.MANIFEST, ck.EXTRA) == (ref.MANIFEST, ref.EXTRA)
    got = ck.save_versioned(str(tmp_path / "port"), 7, _tree(),
                            extra={"s": 7})
    want = ref.save_versioned(str(tmp_path / "ref"), 7,
                              {"a": jnp.arange(4.0)}, extra={"s": 7})
    assert os.path.basename(got) == os.path.basename(want) == "ckpt_00000007"
    for path in (got, want):
        with open(os.path.join(path, ck.MANIFEST)) as f:
            manifest = json.load(f)
        assert set(manifest) == {"version", "files"}
        assert manifest["version"] == 1
        assert ck.EXTRA in manifest["files"]
        assert all(len(d) == 64 for d in manifest["files"].values())
        assert ck.verify_manifest(path) and ref.verify_manifest(path)


def test_corruption_rejected_with_clear_error(tmp_path):
    ck = _ckpt()
    p = str(tmp_path / "ck")
    ck.save_checkpoint(p, _tree())
    _corrupt_one_file(p)
    with pytest.raises(ck.CheckpointCorruptError, match="checksum"):
        ck.restore_checkpoint(p, _template())


def test_bad_manifest_raises_corrupt(tmp_path):
    ck = _ckpt()
    p = str(tmp_path / "ck")
    ck.save_checkpoint(p, _tree(), extra={"x": 1})
    with open(os.path.join(p, ck.MANIFEST), "w") as f:
        f.write("{not json")
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_checkpoint(p, _template())
    with pytest.warns(RuntimeWarning, match="initializing fresh"):
        out = ck.restore_or_init(p, _template)
    assert float(out["a"].sum()) == 0.0


def test_keep_last_k_and_latest_skips_corrupt(tmp_path):
    ck = _ckpt()
    root = str(tmp_path / "v")
    for s in (1, 2, 3, 4, 5):
        ck.save_versioned(root, s, _tree(), extra={"step": s}, keep=2)
    assert sorted(os.listdir(root)) == ["ckpt_00000004", "ckpt_00000005"]
    _corrupt_one_file(os.path.join(root, "ckpt_00000005"))
    step, tree, extra = ck.restore_latest(root, _template())
    assert step == 4 and extra == {"step": 4}
    assert ck.restore_latest(str(tmp_path / "nope"), _template()) is None


@pytest.mark.parametrize("torn", ["file", "empty_dir"])
def test_torn_entry_skipped(tmp_path, torn):
    ck = _ckpt()
    root = str(tmp_path / "v")
    ck.save_versioned(root, 2, _tree(), keep=3)
    if torn == "file":
        open(os.path.join(root, "ckpt_00000009"), "w").close()
    else:
        os.makedirs(os.path.join(root, "ckpt_00000007"))
    assert ck.latest_checkpoint(root)[0] == 2


class _InjectedCrash(BaseException):
    """Stands in for a power cut at a save_checkpoint crash point."""


@pytest.mark.parametrize("tag,latest", [("staged", 2), ("renamed", 4)])
def test_crash_points_leave_a_valid_checkpoint(tmp_path, tag, latest):
    ck = _ckpt()
    root = str(tmp_path / "v")
    ck.save_versioned(root, 2, _tree(), extra={"step": 2}, keep=3)

    def hook(t):
        if t == tag:
            raise _InjectedCrash(t)
    ck._crash_hook = hook
    try:
        with pytest.raises(_InjectedCrash):
            ck.save_versioned(root, 4, _tree(), extra={"step": 4}, keep=3)
    finally:
        ck._crash_hook = None
    step, _, extra = ck.restore_latest(root, _template())
    assert step == latest and extra == {"step": latest}


# ------------------------------------------------------- async writer


def test_async_writes_land_in_order_and_own_their_snapshot(tmp_path):
    ck = _ckpt()
    root = str(tmp_path / "v")
    src = {"w": torch.arange(8, dtype=torch.float32)}
    with ck.AsyncCheckpointer(root, keep=2) as saver:
        for s in (1, 2, 3):
            saver.save(s, src, extra={"step": s})
            src["w"].mul_(-1.0)              # mutated under the writer
    assert sorted(os.listdir(root)) == ["ckpt_00000002", "ckpt_00000003"]
    step, tree, extra = ck.restore_latest(root, {"w": torch.zeros(8)})
    assert step == 3 and extra == {"step": 3}
    assert torch.equal(tree["w"], torch.arange(8, dtype=torch.float32))


def test_async_background_error_surfaces_at_next_join(tmp_path):
    ck = _ckpt()
    blocker = tmp_path / "blocked"
    blocker.write_text("not a directory")
    saver = ck.AsyncCheckpointer(str(blocker / "v"), keep=2)
    saver.save(1, _tree())
    with pytest.raises(OSError):
        saver.flush()
    saver.flush()                            # consumed: reusable after


# ---------------------------------------------------------------- fit()


class _Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3))


def _lin_loss(model, batch, generator):
    x, y = batch
    noise = torch.rand(x.shape[0], generator=generator) * 1e-3
    return ((x @ model.w - y + noise) ** 2).mean(), {}


def _lin_batch(step):
    x = np.random.default_rng(step).standard_normal((8, 3)).astype(np.float32)
    x = torch.from_numpy(x)
    return x, x @ torch.tensor([1.0, -2.0, 0.5])


def _lin_state():
    from tosem_tpu_torch.train import (adamw, create_train_state,
                                       make_train_step)
    model = _Lin()
    st = create_train_state(model, adamw(0.1))
    return st, make_train_step(model, st.optimizer, _lin_loss)


def _fit(n, **kw):
    from tosem_tpu_torch.train import fit
    st, step = _lin_state()
    return fit(st, step, _lin_batch, n, seed=42, **kw)


@pytest.mark.parametrize("async_save", [False, True])
def test_resumed_history_is_bit_exact(tmp_path, async_save):
    _, ref_hist = _fit(10)
    ck = str(tmp_path / "ck")
    _, part = _fit(4, ckpt_dir=ck, checkpoint_every=2, async_save=async_save)
    assert part == ref_hist[:4]
    assert _ckpt().latest_checkpoint(ck)[0] == 4
    state, hist = _fit(10, ckpt_dir=ck, checkpoint_every=2,
                       async_save=async_save)
    assert hist == ref_hist and state.step == 10


@pytest.mark.parametrize("async_save", [False, True])
def test_chaos_preemption_then_resume(tmp_path, async_save):
    """Preempted after step 5 (between checkpoints) or 4 (an async save
    in flight, which the preemption flushes): resume re-derives the rest
    identically."""
    from tosem_tpu_torch.train import TrainingPreempted
    at = 4 if async_save else 5
    ck = str(tmp_path / "ck")
    with _chaos(_Preempt(at)):
        with pytest.raises(TrainingPreempted):
            _fit(10, ckpt_dir=ck, checkpoint_every=2, async_save=async_save)
    assert _ckpt().latest_checkpoint(ck)[0] == 4
    _, hist = _fit(10, ckpt_dir=ck, checkpoint_every=2, async_save=async_save)
    assert hist == _fit(10)[1]


def test_resume_skips_torn_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    _fit(6, ckpt_dir=ck, checkpoint_every=2)
    _corrupt_one_file(os.path.join(ck, "ckpt_00000006"))
    _, hist = _fit(8, ckpt_dir=ck, checkpoint_every=2)
    assert hist == _fit(8)[1]


def test_bert_with_dropout_resumes_bit_exact(tmp_path):
    """Tiny BERT, dropout 0.1, flash attention: each step draws from the
    generator of (seed, step), so the run resumed after a preemption at
    step 3 replays the uninterrupted loss history bit for bit."""
    import functools

    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.train import (TrainingPreempted, adamw,
                                       create_train_state, fit,
                                       make_train_step, mlm_loss)
    cfg = dataclasses.replace(BertConfig.tiny(), dtype="float32",
                              dropout=0.1)

    def batch_fn(step):
        rng = np.random.default_rng(step)
        ids = torch.from_numpy(rng.integers(0, 128, (2, 32)))
        return {"ids": ids, "labels": ids,
                "masked": torch.from_numpy(rng.random((2, 32)) < 0.15)}

    def run(n, **kw):
        model = Bert(cfg, device="cpu", seed=0)
        st = create_train_state(model, adamw(1e-3))
        step = make_train_step(model, st.optimizer, functools.partial(
            mlm_loss, attn_fn=flash_attn_fn()))
        return fit(st, step, batch_fn, n, seed=3, **kw)
    _, want = run(4)
    ck = str(tmp_path / "ck")
    with _chaos(_Preempt(3)):
        with pytest.raises(TrainingPreempted):
            run(4, ckpt_dir=ck, checkpoint_every=2)
    _, got = run(4, ckpt_dir=ck, checkpoint_every=2)
    assert got == want and len({h["loss"] for h in got}) == 4
