"""The port's LM-scored beam decode on the CPU: the JAX package's
``tests/test_scorer.py`` (nine cases) against ``tosem_tpu_torch``'s
scorer tooling (``data/scorer.py``) and native decoder (``native/
ctc_decoder.cpp`` through ``ops/ctc.py``), and a package built by the
port equal byte for byte to the JAX package's.

LM-scored beam decode tests (SURVEY §2.3 CTC-decoder + scorer rows).

The reference decodes with a KenLM word model + prefix trie
(``ctcdecode/scorer.cpp``, ``path_trie.cpp``); these tests build a scorer
package from a toy corpus with the native tooling and check that the
LM-scored beam overrides acoustically-preferred-but-unlikely hypotheses —
the property the reference's external scorer exists for.
"""

import numpy as np
import pytest

from tosem_tpu_torch.data.audio import ALPHABET, labels_to_text
from tosem_tpu_torch.data.scorer import build_scorer
from tosem_tpu_torch.models.speech import evaluate_wer
from tosem_tpu_torch.ops.ctc import Scorer, beam_search_decode

V = len(ALPHABET) + 1          # 28 chars + blank
BLANK = len(ALPHABET)          # 28
SPACE = ALPHABET.index(" ")    # 26


def _frames(chars, peak=0.9, alt=None):
    """Synthetic log-softmax frames: one confident symbol per frame; with
    ``alt=(i, sym, p_alt)`` frame i splits mass between chars[i] and sym."""
    rows = []
    for i, ch in enumerate(chars):
        p = np.full(V, 1e-4, np.float64)
        idx = BLANK if ch == "_" else ALPHABET.index(ch)
        if alt is not None and alt[0] == i:
            a_idx = ALPHABET.index(alt[1])
            p[idx] = 1.0 - alt[2]
            p[a_idx] = alt[2]
        else:
            p[idx] = peak
        p /= p.sum()
        rows.append(np.log(p))
    return np.asarray(rows, np.float32)


@pytest.fixture(scope="module")
def scorer_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "toy.scorer")
    corpus = ["the dog ran", "a dog sat", "dog dog dog",
              "aa dog", "aa dog", "aa dog", "bb dag", "bb dag", "bb dag"]
    vocab = build_scorer(corpus, path, order=3)
    assert "dog" in vocab and "dag" in vocab
    return path


def test_alphabet_stamp_roundtrip(scorer_path, tmp_path):
    from tosem_tpu_torch.data.scorer import read_scorer_alphabet
    assert read_scorer_alphabet(scorer_path) == ALPHABET
    # unstamped (older) package: truncate the trailing stamp → None
    blob = open(scorer_path, "rb").read()
    stamp_len = 4 + len(ALPHABET.encode())
    old = tmp_path / "old.scorer"
    old.write_bytes(blob[:-stamp_len])
    assert read_scorer_alphabet(str(old)) is None
    Scorer(str(old)).close()              # still loads in the decoder


def test_scorer_loads_and_scores(scorer_path):
    sc = Scorer(scorer_path)
    assert sc.order == 3
    assert sc.n_words >= 6
    dog, dag, aa = sc.word_id("dog"), sc.word_id("dag"), sc.word_id("aa")
    assert dog >= 0 and dag >= 0 and aa >= 0
    assert sc.word_id("zebra") == -1                      # OOV
    # unigram: dog appears far more often than dag
    assert sc.score([], dog) > sc.score([], dag)
    # bigram: after "aa", dog is certain; dag backs off with penalty
    assert sc.score([aa], dog) > sc.score([aa], dag) + 1.0
    assert sc.score([aa], dog) == pytest.approx(0.0, abs=1e-5)
    sc.close()


def test_lm_overrides_acoustics(scorer_path):
    # acoustics slightly prefer "dag " (0.55 vs 0.45 on the vowel frame)
    logp = _frames("d?g ".replace("?", "a"), alt=(1, "o", 0.45))
    plain, _ = beam_search_decode(logp, blank=BLANK, beam_width=32)
    assert labels_to_text(plain) == "dag "
    sc = Scorer(scorer_path, alpha=1.5, beta=0.5)
    lm_labels, _ = beam_search_decode(logp, blank=BLANK, beam_width=32,
                                      scorer=sc)
    assert labels_to_text(lm_labels) == "dog "            # LM wins
    sc.close()


def test_bigram_context_disambiguates(scorer_path):
    # same ambiguous word, two contexts: "aa d?g" → dog, "bb d?g" → dag
    # ("_" = blank frame: CTC needs it between repeated symbols)
    sc = Scorer(scorer_path, alpha=1.5, beta=0.5)
    for ctx_frames, ctx, expected in [("a_a", "aa", "dog"),
                                      ("b_b", "bb", "dag")]:
        chars = f"{ctx_frames} d?g "
        vowel = chars.index("?")
        logp = _frames(chars.replace("?", "a"), alt=(vowel, "o", 0.49))
        labels, _ = beam_search_decode(logp, blank=BLANK, beam_width=32,
                                       scorer=sc)
        assert labels_to_text(labels) == f"{ctx} {expected} ", ctx
    sc.close()


def test_wer_eval_with_scorer_beats_plain(scorer_path):
    refs = ["dog ", "aa dog "]
    batch = [
        _frames("dag ", alt=(1, "o", 0.45)),
        _frames("a_a dag ", alt=(5, "o", 0.45)),
    ]
    T = max(len(b) for b in batch)
    lp = np.stack([np.pad(b, ((0, T - len(b)), (0, 0))) for b in batch])
    lengths = np.array([len(b) for b in batch])
    plain = evaluate_wer(lp, lengths, refs, blank=BLANK)
    sc = Scorer(scorer_path, alpha=1.5, beta=0.5)
    with_lm = evaluate_wer(lp, lengths, refs, blank=BLANK, scorer=sc)
    sc.close()
    assert with_lm["wer"] < plain["wer"]
    assert with_lm["wer"] == 0.0


def test_final_word_scored_without_trailing_space(scorer_path):
    # no trailing delimiter: the end-of-utterance pass must still rescore
    logp = _frames("dag", alt=(1, "o", 0.45))
    plain, _ = beam_search_decode(logp, blank=BLANK, beam_width=32)
    assert labels_to_text(plain) == "dag"
    sc = Scorer(scorer_path, alpha=1.5, beta=0.5)
    lm_labels, _ = beam_search_decode(logp, blank=BLANK, beam_width=32,
                                      scorer=sc)
    sc.close()
    assert labels_to_text(lm_labels) == "dog"


def test_closed_scorer_raises(scorer_path):
    sc = Scorer(scorer_path)
    sc.close()
    with pytest.raises(ValueError):
        _ = sc.order
    with pytest.raises(ValueError):
        beam_search_decode(_frames("dag"), blank=BLANK, scorer=sc)


def test_long_utterance_decodes(scorer_path):
    # T > compaction interval: exercises the trie mark-sweep path
    chars = ("dog " * 40)[:150]
    logp = _frames(chars)
    sc = Scorer(scorer_path, alpha=1.0, beta=0.2)
    labels, _ = beam_search_decode(logp, blank=BLANK, beam_width=16,
                                   scorer=sc)
    sc.close()
    assert "dog dog" in labels_to_text(labels)


def test_plain_beam_regression_unchanged():
    # the trie rewrite must preserve plain prefix-beam semantics
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels, score = beam_search_decode(logp, blank=0, beam_width=64)
    # brute force over all alignments
    from itertools import product
    best = {}
    for path in product(range(4), repeat=6):
        p = sum(logp[t, s] for t, s in enumerate(path))
        out = []
        prev = -1
        for s in path:
            if s != 0 and s != prev:
                out.append(s)
            prev = s
        key = tuple(out)
        best[key] = np.logaddexp(best.get(key, -np.inf), p)
    want = max(best, key=best.get)
    assert tuple(labels) == want
    assert score == pytest.approx(best[want], abs=1e-3)


def test_package_bytes_equal_the_reference(tmp_path):
    from tosem_tpu.data.scorer import build_scorer as j_build
    corpus = ["the dog ran", "a dog sat", "dog dog dog", "aa dog", "bb dag"]
    a, b = str(tmp_path / "port.scorer"), str(tmp_path / "ref.scorer")
    assert build_scorer(corpus, a, order=3) == j_build(corpus, b, order=3)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
