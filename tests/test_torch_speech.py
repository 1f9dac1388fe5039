"""The port's speech family on the CPU: CTC loss and decoders, the
streaming LSTM acoustic model, MFCC, sample collections.

The JAX package's ``tests/test_speech.py`` (21 cases) against the port,
then the port held to the JAX package on the same seeded numpy inputs:
CTC loss within 1e-5 and its gradient within 1e-5 (fp32); greedy and beam
decode equal; ``SpeechModel`` logits (the reference's initial weights,
carried by ``load_speech_params``) within 2e-5, in a full pass and
streamed in chunks; MFCC within 1e-4 of the largest coefficient; the
synthetic corpus byte for byte, and ``speech_batches`` with equal labels
and features within the MFCC tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = 2e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _random_case(seed, B=3, T=20, V=6, L=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, L)).astype(np.int32)   # 0 is blank
    il = np.array([T, T - 3, T - 7], np.int32)
    ll = np.array([L, L - 1, L - 3], np.int32)
    return logits, labels, il, ll


def _optax_loss(logits, labels, il, ll):
    import jax.numpy as jnp
    import optax
    B, T, V = logits.shape
    L = labels.shape[1]
    logit_pad = (np.arange(T)[None, :] >= il[:, None]).astype(np.float32)
    label_pad = (np.arange(L)[None, :] >= ll[:, None]).astype(np.float32)
    return optax.ctc_loss(jnp.asarray(logits), jnp.asarray(logit_pad),
                          jnp.asarray(labels), jnp.asarray(label_pad),
                          blank_id=0)


class TestCTCLoss:
    def test_matches_optax(self):
        from tosem_tpu_torch.ops.ctc import ctc_loss
        logits, labels, il, ll = _random_case(0)
        ours = ctc_loss(_t(logits), _t(labels), _t(il), _t(ll), blank=0)
        theirs = _optax_loss(logits, labels, il, ll)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)

    def test_gradient_matches_optax(self):
        import jax
        import jax.numpy as jnp
        import optax
        from tosem_tpu_torch.ops.ctc import ctc_loss
        logits, labels, il, ll = _random_case(1)
        x = _t(logits).requires_grad_(True)
        ctc_loss(x, _t(labels), _t(il), _t(ll)).sum().backward()
        T, L = logits.shape[1], labels.shape[1]
        lp = (np.arange(T)[None, :] >= il[:, None]).astype(np.float32)
        lbp = (np.arange(L)[None, :] >= ll[:, None]).astype(np.float32)
        g = jax.grad(lambda lg: jnp.sum(optax.ctc_loss(
            lg, jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(lbp))))(
            jnp.asarray(logits))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   rtol=1e-3, atol=1e-3)

    def test_perfect_alignment_low_loss(self):
        from tosem_tpu_torch.ops.ctc import ctc_loss
        logits = torch.full((1, 3, 4), -20.0)
        logits[0, 0, 1] = logits[0, 1, 2] = logits[0, 2, 3] = 20.0
        loss = ctc_loss(logits, torch.tensor([[1, 2, 3]]), torch.tensor([3]),
                        torch.tensor([3]))
        assert float(loss[0]) < 1e-3

    def test_mean_is_the_mean_of_rows(self):
        from tosem_tpu_torch.ops.ctc import ctc_loss, ctc_loss_mean
        logits, labels, il, ll = _random_case(2)
        args = (_t(logits), _t(labels), _t(il), _t(ll))
        m = ctc_loss_mean(*args)
        assert np.isfinite(float(m))
        assert float(m) == pytest.approx(float(ctc_loss(*args).mean()))


class TestDecoders:
    def test_greedy_collapse(self):
        from tosem_tpu_torch.ops.ctc import greedy_decode
        V = 4
        path = [2, 2, 1, 3, 3, 0, 3]
        logits = np.full((1, len(path), V), -10.0, np.float32)
        for t, s in enumerate(path):
            logits[0, t, s] = 10.0
        labels, lengths = greedy_decode(_t(logits), None, blank=0)
        n = int(lengths[0])
        assert labels[0][:n].tolist() == [2, 1, 3, 3]

    @staticmethod
    def _brute_force_best(logp, blank):
        import itertools
        T, V = logp.shape
        totals = {}
        for path in itertools.product(range(V), repeat=T):
            lab, prev = [], -1
            for s in path:
                if s != blank and s != prev:
                    lab.append(s)
                prev = s
            p = sum(logp[t, s] for t, s in enumerate(path))
            totals[tuple(lab)] = np.logaddexp(
                totals.get(tuple(lab), -np.inf), p)
        return max(totals.items(), key=lambda kv: kv[1])

    def test_beam_matches_brute_force(self):
        from tosem_tpu_torch.ops.ctc import beam_search_decode
        rng = np.random.default_rng(0)
        for _ in range(5):
            logits = rng.normal(size=(5, 3)).astype(np.float32)
            logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
            best_lab, _ = self._brute_force_best(logp, blank=0)
            labels, _ = beam_search_decode(logp, blank=0, beam_width=64)
            assert tuple(labels) == best_lab

    def test_beam_bonus_biases_output(self):
        from tosem_tpu_torch.ops.ctc import beam_search_decode
        logp = np.log(np.array([[1e-6, 0.51, 0.49]], np.float32))
        no_bonus, _ = beam_search_decode(logp, blank=0, beam_width=16)
        with_bonus, _ = beam_search_decode(
            logp, blank=0, beam_width=16,
            bonus=np.array([0.0, 0.0, 2.0], np.float32))
        assert no_bonus == [1]
        assert with_bonus == [2]


@functools.lru_cache(maxsize=None)
def _speech_pair(seed=0):
    """The JAX package's tiny speech model and its initial weights in the
    port."""
    import jax
    from tosem_tpu.models.speech import SpeechConfig as JConfig
    from tosem_tpu.models.speech import SpeechModel as JModel
    from tosem_tpu_torch.models.convert import load_speech_params
    from tosem_tpu_torch.models.speech import SpeechConfig, SpeechModel
    jcfg = JConfig.tiny()
    jm = JModel(jcfg)
    vs = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, vs["params"])
    pm = SpeechModel(SpeechConfig(**dataclasses.asdict(jcfg)), device="cpu",
                     seed=seed + 1)
    load_speech_params(pm, tree)
    return jm, vs, pm, tree


class TestSpeechModel:
    def test_forward_shapes(self):
        from tosem_tpu_torch.models.speech import SpeechConfig, SpeechModel
        cfg = SpeechConfig.tiny()
        model = SpeechModel(cfg, device="cpu")
        logits, carry = model(torch.zeros(2, 30, cfg.n_input))
        assert logits.shape == (2, 30, cfg.n_classes)
        assert carry[0].shape == (2, cfg.n_cell)

    def test_streaming_matches_full_forward(self):
        from tosem_tpu_torch.models.speech import SpeechConfig, SpeechModel
        cfg = SpeechConfig.tiny()
        model = SpeechModel(cfg, device="cpu")
        feats = torch.from_numpy(np.random.default_rng(1).normal(
            size=(1, 24, cfg.n_input)).astype(np.float32))
        with torch.no_grad():
            full, _ = model(feats)
            state = model.streaming_init(batch=1)
            outs = []
            for start in range(0, 24, 8):        # three 8-frame chunks
                logits, state = model.streaming_step(
                    state, feats[:, start:start + 8])
                outs.append(logits)
            tail, state = model.streaming_flush(state)
        stream = torch.cat(outs + [tail], 1)
        assert stream.shape == full.shape
        torch.testing.assert_close(stream, full, rtol=1e-4, atol=1e-4)

    def test_tiny_overfit_single_sample(self):
        """The LDC93S1-style smoke train: overfit one synthetic utterance
        until greedy decode returns the target labels."""
        from tosem_tpu_torch.models.speech import SpeechConfig, SpeechModel
        from tosem_tpu_torch.ops.ctc import ctc_loss_mean, greedy_decode
        cfg = SpeechConfig.tiny()
        model = SpeechModel(cfg, device="cpu")
        feats = torch.from_numpy(np.random.default_rng(1).normal(
            size=(1, 20, cfg.n_input)).astype(np.float32))
        labels = torch.tensor([[3, 7, 1, 7, 5]])
        il, ll = torch.tensor([20]), torch.tensor([5])
        opt = torch.optim.Adam(model.parameters(), lr=3e-3)
        losses = []
        for _ in range(250):
            logits, _ = model(feats)
            loss = ctc_loss_mean(logits, labels, il, ll, blank=cfg.blank)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        assert losses[-1] < 0.1 * losses[0]
        with torch.no_grad():
            logits, _ = model(feats)
        dec, n = greedy_decode(logits, il, blank=cfg.blank)
        assert dec[0][:int(n[0])].tolist() == [3, 7, 1, 7, 5]


class TestAudio:
    def test_mfcc_shapes(self):
        from tosem_tpu_torch.data.audio import mfcc
        audio = _t(np.random.default_rng(0).normal(
            size=(2, 16000)).astype(np.float32))
        feats = mfcc(audio, sample_rate=16000, n_mfcc=26)
        assert feats.shape[0] == 2 and feats.shape[2] == 26
        assert feats.shape[1] == 1 + (16000 - 400) // 160
        assert bool(torch.all(torch.isfinite(feats)))

    def test_mfcc_distinguishes_tones(self):
        from tosem_tpu_torch.data.audio import mfcc
        t = np.arange(16000) / 16000.0
        low = np.sin(2 * np.pi * 200 * t).astype(np.float32)
        high = np.sin(2 * np.pi * 3000 * t).astype(np.float32)
        f = mfcc(_t(np.stack([low, high])))
        assert float((f[0] - f[1]).abs().mean()) > 0.1

    def test_spec_augment_masks(self):
        from tosem_tpu_torch.data.audio import spec_augment
        feats = torch.ones(2, 50, 13)
        out = spec_augment(feats, torch.Generator().manual_seed(0),
                           time_masks=1, time_width=5, freq_masks=1,
                           freq_width=2)
        assert out.shape == feats.shape
        assert float(out.min()) == 0.0          # something got masked
        assert float(out.mean()) > 0.6          # but not most of it

    def test_text_roundtrip(self):
        from tosem_tpu_torch.data.audio import labels_to_text, text_to_labels
        s = "hello world's"
        assert labels_to_text(text_to_labels(s)) == s


class TestMetrics:
    def test_wer_cer(self):
        from tosem_tpu_torch.models.speech import cer, wer
        assert wer("the cat sat", "the cat sat") == 0.0
        assert wer("the cat sat", "the bat sat") == pytest.approx(1 / 3)
        assert cer("abc", "axc") == pytest.approx(1 / 3)
        assert wer("a b", "") == 1.0


class TestSampleCollections:
    def test_sdb_roundtrip_and_random_access(self, tmp_path):
        from tosem_tpu_torch.data.sample_collections import (SDBReader,
                                                             SDBWriter)
        rng = np.random.default_rng(0)
        waves = [rng.uniform(-0.5, 0.5, rng.integers(800, 2000))
                 .astype(np.float32) for _ in range(5)]
        path = str(tmp_path / "c.sdb")
        with SDBWriter(path) as w:
            for i, a in enumerate(waves):
                w.add(a, f"utt {i}", sample_id=f"u{i}")
        r = SDBReader(path)
        try:
            assert len(r) == 5
            for i in (3, 0, 4):
                assert r[i].transcript == f"utt {i}"
                np.testing.assert_allclose(r[i].load_audio(), waves[i],
                                           atol=1.5 / 32768)
            sizes = [s.size_bytes for s in r.sorted_by_size()]
            assert sizes == sorted(sizes)
        finally:
            r.close()

    def test_csv_to_sdb_and_open_collection(self, tmp_path):
        from tosem_tpu_torch.data.feeding import (import_synthetic_corpus,
                                                  read_csv_manifest)
        from tosem_tpu_torch.data.sample_collections import (csv_to_sdb,
                                                             open_collection)
        manifest = import_synthetic_corpus(str(tmp_path), n=3, seed=1)
        sdb = csv_to_sdb(manifest, str(tmp_path / "c.sdb"))
        csv_coll = read_csv_manifest(manifest)
        sdb_coll = open_collection(sdb)
        assert [s.transcript for s in sdb_coll] == \
            [s.transcript for s in csv_coll]
        np.testing.assert_allclose(csv_coll[0].load_audio(),
                                   sdb_coll[0].load_audio(),
                                   atol=1.5 / 32768)
        assert len(open_collection(manifest)) == 3

    def test_speech_batches_accepts_sdb(self, tmp_path):
        from tosem_tpu_torch.data.feeding import (import_synthetic_corpus,
                                                  speech_batches)
        from tosem_tpu_torch.data.sample_collections import csv_to_sdb
        manifest = import_synthetic_corpus(str(tmp_path), n=4, seed=2)
        sdb = csv_to_sdb(manifest, str(tmp_path / "c.sdb"))
        batches = list(speech_batches(sdb, batch_size=2, n_buckets=1,
                                      max_label_len=24, device="cpu"))
        assert batches and all(b.features.ndim == 3 for b in batches)

    def test_import_ldc93s1_fabricated(self, tmp_path):
        from tosem_tpu_torch.data.feeding import read_csv_manifest
        from tosem_tpu_torch.data.sample_collections import import_ldc93s1
        coll = read_csv_manifest(import_ldc93s1(str(tmp_path),
                                                fabricate=True))
        assert len(coll) == 1
        assert coll[0].transcript == ("she had your dark suit in greasy "
                                      "wash water all year")
        assert coll[0].load_audio().size > 0

    def test_import_ldc93s1_requires_files_or_fabricate(self, tmp_path):
        from tosem_tpu_torch.data.sample_collections import import_ldc93s1
        with pytest.raises(FileNotFoundError):
            import_ldc93s1(str(tmp_path / "empty"))

    def test_corrupt_sdb_rejected(self, tmp_path):
        from tosem_tpu_torch.data.sample_collections import SDBReader
        p = tmp_path / "bad.sdb"
        p.write_bytes(b"NOTMAGIC" + b"\x00" * 64)
        with pytest.raises(ValueError):
            SDBReader(str(p))


# ------------------------------------------------ held to the JAX package


@pytest.mark.parametrize("seed,blank", [(0, 0), (3, 5)])
def test_ctc_loss_and_gradient_match_the_reference(seed, blank):
    import jax
    import jax.numpy as jnp
    from tosem_tpu.ops.ctc import ctc_loss as j_ctc
    from tosem_tpu_torch.ops.ctc import ctc_loss
    rng = np.random.default_rng(seed)
    B, T, V, L = 4, 30, 6, 7
    logits = (3 * rng.normal(size=(B, T, V))).astype(np.float32)
    labels = rng.integers(0, V - 1, (B, L)).astype(np.int32)
    labels[labels >= blank] += 1                # never the blank
    il = np.array([T, T - 5, 9, 1], np.int32)
    ll = np.array([L, 3, 4, 0], np.int32)       # one row with no label
    args = tuple(jnp.asarray(a) for a in (labels, il, ll))
    want = j_ctc(jnp.asarray(logits), *args, blank=blank)
    g_want = jax.grad(lambda lg: j_ctc(lg, *args, blank=blank).sum())(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = ctc_loss(x, _t(labels), _t(il), _t(ll), blank=blank)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want),
                               rtol=1e-5, atol=1e-5)


def test_greedy_decode_matches_the_reference():
    import jax.numpy as jnp
    from tosem_tpu.ops.ctc import greedy_decode as j_greedy
    from tosem_tpu_torch.ops.ctc import greedy_decode
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 25, 5)).astype(np.float32)
    il = np.array([25, 11, 1], np.int32)
    want, wn = j_greedy(jnp.asarray(logits), jnp.asarray(il), blank=4)
    got, gn = greedy_decode(_t(logits), _t(il), blank=4)
    assert gn.tolist() == np.asarray(wn).tolist()
    assert got.tolist() == np.asarray(want).tolist()


def test_beam_decode_matches_the_reference():
    from tosem_tpu.ops.ctc import beam_search_decode as j_beam
    from tosem_tpu_torch.ops.ctc import beam_search_decode
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(40, 8)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    bonus = rng.uniform(0, 0.5, 8).astype(np.float32)
    for kw in ({}, {"bonus": bonus}):
        want = j_beam(logp, blank=7, beam_width=8, **kw)
        got = beam_search_decode(_t(logp), blank=7, beam_width=8, **kw)
        assert got[0] == want[0]
        assert got[1] == pytest.approx(want[1], abs=1e-6)


def test_speech_model_matches_the_reference():
    import jax.numpy as jnp
    jm, vs, pm, tree = _speech_pair()
    from tosem_tpu_torch.models.convert import speech_params_from_numpy
    sd = speech_params_from_numpy(tree)
    assert set(sd) == set(pm.state_dict())
    feats = np.random.default_rng(7).normal(size=(2, 33, 13)).astype(
        np.float32)
    want, (wh, wc) = jm.apply(vs, jnp.asarray(feats))
    with torch.no_grad():
        got, (gh, gc) = pm(_t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=TOL,
                               atol=TOL)


def test_streamed_logits_match_the_reference():
    """The port's streaming steps in uneven chunks against the JAX
    package's, on one set of weights."""
    import jax.numpy as jnp
    jm, vs, pm, _ = _speech_pair()
    feats = np.random.default_rng(8).normal(size=(1, 29, 13)).astype(
        np.float32)
    j_state, p_state = jm.streaming_init(batch=1), pm.streaming_init(1)
    j_out, p_out = [], []
    with torch.no_grad():
        for a, b in ((0, 5), (5, 6), (6, 20), (20, 29)):
            lj, j_state = jm.streaming_step(vs, j_state,
                                            jnp.asarray(feats[:, a:b]))
            lp, p_state = pm.streaming_step(p_state, _t(feats[:, a:b]))
            j_out.append(np.asarray(lj))
            p_out.append(lp.numpy())
        lj, _ = jm.streaming_flush(vs, j_state)
        lp, _ = pm.streaming_flush(p_state)
    want = np.concatenate(j_out + [np.asarray(lj)], 1)
    got = np.concatenate(p_out + [lp.numpy()], 1)
    assert got.shape == want.shape == (1, 29, 13)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_mfcc_matches_the_reference():
    import jax.numpy as jnp
    from tosem_tpu.data.audio import mfcc as j_mfcc
    from tosem_tpu_torch.data.audio import mfcc
    rng = np.random.default_rng(9)
    t = np.arange(12000) / 16000.0
    audio = np.stack([0.3 * np.sin(2 * np.pi * 180 * t)
                      + 0.1 * rng.normal(size=t.shape),
                      rng.uniform(-0.5, 0.5, t.shape)]).astype(np.float32)
    want = np.asarray(j_mfcc(jnp.asarray(audio)))
    got = mfcc(_t(audio)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_spec_augment_covers_what_the_reference_covers():
    """Different draws, the same masks' shape: each row loses whole
    frames and whole coefficients, at most the bands' widths of each."""
    from tosem_tpu_torch.data.audio import spec_augment
    out = spec_augment(torch.ones(8, 60, 26), torch.Generator()
                       .manual_seed(3))
    for row in out:
        dead_t = (row == 0).all(1).sum()
        dead_f = (row == 0).all(0).sum()
        assert 10 <= dead_t <= 20 and 4 <= dead_f <= 8
        live = row[(row != 0).any(1)][:, (row != 0).any(0)]
        assert bool((live == 1).all())


def test_synthetic_corpus_and_batches_match_the_reference(tmp_path):
    from tosem_tpu.data import feeding as jf
    from tosem_tpu_torch.data import feeding as pf
    m_ref = jf.import_synthetic_corpus(str(tmp_path / "ref"), n=5, seed=3)
    m_port = pf.import_synthetic_corpus(str(tmp_path / "port"), n=5, seed=3)
    ref, port = jf.read_csv_manifest(m_ref), pf.read_csv_manifest(m_port)
    assert [s.transcript for s in port] == [s.transcript for s in ref]
    for a, b in zip(ref, port):
        with open(a.audio_path, "rb") as fa, open(b.audio_path, "rb") as fb:
            assert fa.read() == fb.read()
    kw = dict(batch_size=2, n_buckets=2, max_label_len=24)
    want = list(jf.speech_batches(m_ref, **kw))
    got = list(pf.speech_batches(m_port, device="cpu", **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.features.shape == w.features.shape
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.feature_lengths, w.feature_lengths)
        assert np.abs(g.features - w.features).max() \
            <= 1e-4 * np.abs(w.features).max()


def test_speech_batches_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from tosem_tpu_torch.data.feeding import (import_synthetic_corpus,
                                              speech_batches)
    manifest = import_synthetic_corpus(str(tmp_path), n=2, seed=0)
    with pytest.raises(RuntimeError, match="is_available"):
        next(speech_batches(manifest, batch_size=2, n_buckets=1))
