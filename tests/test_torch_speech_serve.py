"""The port's speech serving on the CPU (``tosem_tpu_torch/serve/speech.py``).

Copies, against the port, of the JAX package's speech serving tests:
``tests/test_serve.py``'s ``TestCStreamingAPI`` (the native speech C ABI
driven through ctypes callbacks) and ``TestStreamingThroughServe`` (a
stream that survives its replica's death by client replay),
``tests/test_serve_batching.py``'s batched-vs-sequential speech test on
``Serve``'s micro-batch plane, and ``tests/test_decode_serve.py``'s
``TestSpeechDecodeBackend``. Beside them: the streamed decode behind the
port's ``DecodeQueue`` equal to the full pass, the logits rows of each
path within 1e-5 of the full pass's (fp32), and the C ABI on the JAX
package's weights giving the JAX package's text.

Replicas run in spawned processes at ``num_workers=2``, one intra-op
thread each, on ``device="cpu"``.
"""
import numpy as np
import pytest
import torch

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.data.feeding import pad_target

torch.set_num_threads(1)

ROW_TOL = 1e-5


@pytest.fixture(scope="module")
def serve():
    from tosem_tpu_torch.serve.core import Serve
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        own = not rt.is_initialized()
        if own:
            rt.init(num_workers=2, memory_monitor=False)
        s = Serve()
        yield s
        for name in list(s.list_deployments()):
            s.delete(name)
        if own:
            rt.shutdown()


def _tiny(seed=0):
    from tosem_tpu_torch.serve.speech import SERVE_ALPHABET, \
        build_speech_model
    model = build_speech_model("tiny", seed=seed, device="cpu")
    return model, SERVE_ALPHABET[:model.cfg.n_classes - 1]


def _full_logits(model, feats):
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(feats, np.float32))[None]
                     )[0][0].numpy()


class TestCStreamingAPI:
    @pytest.fixture(scope="class")
    def cmodel(self):
        from tosem_tpu_torch.serve.speech import CStreamingModel
        model, alphabet = _tiny()
        cm = CStreamingModel(model, alphabet, chunk_frames=8)
        yield cm, model, alphabet
        cm.close()

    def test_streaming_matches_full_forward(self, cmodel):
        from tosem_tpu_torch.serve.speech import greedy_ctc_text
        cm, model, alphabet = cmodel
        feats = np.random.default_rng(1).normal(
            size=(30, model.cfg.n_input)).astype(np.float32)
        stream = cm.create_stream()
        for start in range(0, 30, 7):      # uneven chunks on purpose
            cm.feed(stream, feats[start:start + 7])
        mid = cm.intermediate(stream)
        text = cm.finish(stream)
        expect = greedy_ctc_text(_full_logits(model, feats), alphabet,
                                 model.cfg.blank)
        assert text == expect
        assert expect.startswith(mid) or mid in expect

    def test_external_scorer_enable_disable(self, tmp_path, monkeypatch):
        import tosem_tpu_torch.ops.ctc as ctc_mod
        from tosem_tpu_torch.data.audio import ALPHABET
        from tosem_tpu_torch.data.scorer import build_scorer
        from tosem_tpu_torch.models.speech import SpeechConfig, SpeechModel
        from tosem_tpu_torch.serve.speech import CStreamingModel
        cfg = SpeechConfig(n_input=8, n_context=1, n_hidden=32, n_cell=32,
                           vocab_size=28, dropout=0.0)
        cm = CStreamingModel(SpeechModel(cfg, device="cpu"), ALPHABET,
                             chunk_frames=8)
        try:
            path = str(tmp_path / "toy.scorer")
            build_scorer(["the dog ran", "dog dog"], path, order=2)
            calls = []
            real_beam = ctc_mod.beam_search_decode

            def spy(*a, **k):
                calls.append(k.get("scorer"))
                return real_beam(*a, **k)

            monkeypatch.setattr(ctc_mod, "beam_search_decode", spy)
            cm.enable_external_scorer(path, alpha=1.0, beta=0.2)
            assert cm._scorer.space_index == ALPHABET.index(" ")
            feats = np.random.default_rng(2).normal(
                size=(20, cfg.n_input)).astype(np.float32)
            s = cm.create_stream()
            cm.feed(s, feats)
            assert isinstance(cm.finish(s), str)
            assert calls and calls[0] is not None     # the LM beam ran
            # a bad path keeps the working scorer
            with pytest.raises(FileNotFoundError):
                cm.enable_external_scorer(str(tmp_path / "nope.scorer"))
            assert cm._scorer is not None
            cm.disable_external_scorer()
            assert cm._scorer is None
            s2 = cm.create_stream()
            cm.feed(s2, feats)
            assert isinstance(cm.finish(s2), str)     # greedy again
            assert len(calls) == 1
            bad = str(tmp_path / "mismatch.scorer")
            build_scorer(["abc abc"], bad, alphabet="abcdef ")
            with pytest.raises(ValueError, match="alphabet"):
                cm.enable_external_scorer(bad)
        finally:
            cm.close()

    def test_finish_twice_is_error(self, cmodel):
        cm, model, _ = cmodel
        s = cm.create_stream()
        cm.feed(s, np.zeros((4, model.cfg.n_input), np.float32))
        cm.finish(s)
        # the stream was freed by finish; a new one still works
        s2 = cm.create_stream()
        cm.feed(s2, np.zeros((4, model.cfg.n_input), np.float32))
        cm.finish(s2)

    def test_reference_weights_give_the_reference_text(self):
        """The JAX package's weights through the port's C ABI give the
        JAX package's greedy text of the full pass."""
        import jax
        import jax.numpy as jnp
        from tosem_tpu.models.speech import SpeechConfig as JConfig
        from tosem_tpu.models.speech import SpeechModel as JModel
        from tosem_tpu.serve.speech import greedy_ctc_text as j_text
        from tosem_tpu_torch.serve.speech import (CStreamingModel,
                                                  build_speech_model)
        jm = JModel(JConfig.tiny())
        vs = jm.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, vs["params"])
        model = build_speech_model("tiny", device="cpu", params=tree)
        alphabet = "abcdefghijklmnopqrstuvwxyz' -"[:model.cfg.n_classes - 1]
        feats = np.random.default_rng(5).normal(size=(41, 13)).astype(
            np.float32)
        want_logits = np.asarray(jm.apply(vs, jnp.asarray(feats[None]))[0])
        np.testing.assert_allclose(_full_logits(model, feats),
                                   want_logits[0], rtol=2e-5, atol=2e-5)
        cm = CStreamingModel(model, alphabet, chunk_frames=8)
        try:
            s = cm.create_stream()
            for a in range(0, 41, 9):
                cm.feed(s, feats[a:a + 9])
            assert cm.finish(s) == j_text(want_logits[0], alphabet,
                                          JConfig.tiny().blank)
        finally:
            cm.close()


class TestStreamingThroughServe:
    def test_stream_survives_replica_kill(self, serve):
        from tosem_tpu_torch.runtime import api as rt_api
        from tosem_tpu_torch.serve.speech import (SpeechStreamBackend,
                                                  StreamingClient)
        serve.deploy("speech", SpeechStreamBackend, num_replicas=1,
                     init_kwargs={"chunk_frames": 8, "device": "cpu"},
                     max_restarts=2)
        dep = serve._deployments["speech"]
        h = dep.handle(pin=0)     # session affinity
        feats = np.random.default_rng(2).normal(size=(40, 13)).astype(
            np.float32)
        ref_client = StreamingClient(h, "ref")
        for i in range(0, 40, 10):
            ref_client.feed(feats[i:i + 10])
        expect = ref_client.finish()
        # interrupted pass: the replica dies mid-stream
        client = StreamingClient(h, "s1")
        client.feed(feats[:10])
        client.feed(feats[10:20])
        actor_id = dep._replicas[0]._actor_id
        rt_api._runtime.actors[actor_id].worker.proc.kill()
        client.feed(feats[20:30])  # recovers by replay
        client.feed(feats[30:40])
        assert client.finish() == expect
        serve.delete("speech")


def test_speech_batched_vs_sequential_bitexact(serve):
    from tosem_tpu_torch.serve.speech import SpeechBatchBackend
    kw = {"cfg_name": "tiny", "seed": 1, "max_batch": 4, "device": "cpu"}
    serve.deploy("speechb", SpeechBatchBackend, num_replicas=1,
                 init_kwargs=kw, max_batch_size=4, batch_wait_ms=150.0,
                 buckets=[16, 32], length_of=SpeechBatchBackend.length_of,
                 warmup_shapes=[16, 32])
    rng = np.random.default_rng(0)
    lens = [10, 14, 25, 30]
    reqs = [{"frames": rng.normal(size=(t, 13)).astype(np.float32)
             .tolist()} for t in lens]
    h = serve.get_handle("speechb")
    futs = [h.remote(r) for r in reqs]
    batched = [f.result(timeout=300.0) for f in futs]
    local = SpeechBatchBackend(**kw)
    for out, r, t in zip(batched, reqs, lens):
        ref = local.call_batch([r], pad_to=pad_target(t, [16, 32]))[0]
        assert out["frames"] == ref["frames"] == t
        assert out["text"] == ref["text"]
    serve.delete("speechb")


def test_speech_batch_rows_match_the_full_pass():
    """A row's logits in a padded batch of 4 equal its own full pass."""
    from tosem_tpu_torch.serve.speech import SpeechBatchBackend
    b = SpeechBatchBackend(max_batch=4, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [{"frames": rng.normal(size=(t, 13)).astype(np.float32)}
            for t in (9, 31, 17)]
    logits, lengths = b.logits_batch(reqs, pad_to=32)
    for i, r in enumerate(reqs):
        n = int(lengths[i])
        np.testing.assert_allclose(logits[i, :n],
                                   _full_logits(b.model, r["frames"]),
                                   rtol=ROW_TOL, atol=ROW_TOL)


class TestSpeechDecodeBackend:
    @staticmethod
    def make(**over):
        from tosem_tpu_torch.serve.speech import SpeechDecodeBackend
        kw = dict(max_batch=4, chunk_frames=8, max_frames=128,
                  device="cpu")
        kw.update(over)
        return SpeechDecodeBackend(**kw)

    @staticmethod
    def drive_all(b, named_frames):
        outs = {sid: b.admit(sid, {"frames": f})
                for sid, f in named_frames.items()}
        step = 0
        active = [s for s in outs if not outs[s].get("done")]
        while active:
            for sid, out in zip(active, b.step_batch(
                    active, [step] * len(active))):
                outs[sid] = out
            active = [s for s in active if not outs[s].get("done")]
            step += 1
        return ({sid: b.result(sid) for sid in named_frames},
                {sid: b.logits_rows(sid) for sid in named_frames})

    def test_streamed_decode_matches_full_pass(self):
        from tosem_tpu_torch.serve.speech import greedy_ctc_text
        b = self.make()
        rng = np.random.default_rng(0)
        frames = {f"u{i}": rng.normal(size=(n, b.cfg.n_input))
                  .astype(np.float32) for i, n in enumerate((23, 40, 7))}
        got, rows = self.drive_all(b, frames)
        for sid, f in frames.items():
            full = _full_logits(b.model, f)
            assert got[sid]["text"] == greedy_ctc_text(full, b.alphabet,
                                                       b.cfg.blank)
            assert got[sid]["frames"] == f.shape[0]
            np.testing.assert_allclose(rows[sid], full, rtol=ROW_TOL,
                                       atol=ROW_TOL)

    def test_step_replay_is_idempotent(self):
        b = self.make()
        b.admit("u", {"frames": np.random.default_rng(1).normal(
            size=(20, b.cfg.n_input)).astype(np.float32)})
        first = b.step_batch(["u"], [0])
        h_before = b._seqs["u"].h.clone()
        assert b.step_batch(["u"], [0]) == first
        assert torch.equal(b._seqs["u"].h, h_before)

    def test_poison_frames_rejected(self):
        b = self.make()
        with pytest.raises(ValueError):
            b.admit("u", {"frames": np.zeros((0, b.cfg.n_input),
                                             np.float32)})


def test_speech_decode_through_the_decode_queue(serve):
    """8 utterances through ``DecodeQueue`` (4 rows packed a step), each
    answer the greedy text of its own full pass."""
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.speech import (SpeechDecodeBackend,
                                              greedy_ctc_text)
    kw = dict(max_batch=4, chunk_frames=8, max_frames=128, device="cpu")
    serve.deploy("speechd", SpeechDecodeBackend, num_replicas=1,
                 init_kwargs=kw, decode_policy=DecodePolicy(max_active=4))
    rng = np.random.default_rng(4)
    utts = [rng.normal(size=(int(n), 13)).astype(np.float32)
            for n in rng.integers(5, 60, 8)]
    h = serve.get_handle("speechd")
    futs = [h.remote({"frames": u.tolist()}) for u in utts]
    got = [f.result(timeout=300.0) for f in futs]
    local = SpeechDecodeBackend(**kw)
    for out, u in zip(got, utts):
        assert out["frames"] == len(u)
        assert out["text"] == greedy_ctc_text(
            _full_logits(local.model, u), local.alphabet, local.cfg.blank)
    serve.delete("speechd")
