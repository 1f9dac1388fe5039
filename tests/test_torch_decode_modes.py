"""The port's decode modes on the CPU at the tiny preset: sliding-window
decode, speculative decode, beam and sampling groups, multi-turn
sessions, and spill and migration mid-decode.

Copies, against :class:`tosem_tpu_torch.serve.backends.BertDecodeBackend`,
of ``tests/test_decode_modes.py``'s ``TestSpeculative``, ``TestWindow``
and ``TestGroups``, ``tests/test_decode_serve.py``'s spill tests (spill
mid-decode, a lost payload re-prefilled, a lost payload under pressure),
``tests/test_prefix_cache.py``'s session test, and
``tests/test_kv_migration.py``'s ``TestBackendMigration`` (its two
transport tests wait for ROADMAP.md A11).

Across packages, the JAX package's tiny weights go through the port's
weight converter, and the port's streams equal the JAX package's token
for token under a window, a window with speculation, speculation, a
session's second turn and beam search (best branch; every beam's score
within 1e-4). Both packages run those at an fp32 tiny config (the
``fp32_configs`` fixture swaps each package's ``BertConfig`` for a
subclass whose default dtype is float32): at bf16 the two packages'
matmuls round differently, so beam scores part by ~2e-3 and a near-tie
could flip a token.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

DECODE_KW = dict(max_batch=8, max_len=128, page_size=16, num_pages=96,
                 max_new_tokens=24)
LONG_KW = dict(max_batch=8, max_len=256, page_size=16, num_pages=96,
               max_new_tokens=96)
PROMPT = {"ids": [1 + ((7 + j) % 126) for j in range(12)]}


def make_backend(**over):
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    kw = dict(DECODE_KW, device="cpu")
    kw.update(over)
    return BertDecodeBackend(**kw)


def drive(backend, sid, req):
    out = backend.admit(sid, req)
    step = 0
    while not out.get("done"):
        out = backend.step_batch([sid], [step])[0]
        step += 1
    res = backend.result(sid)
    backend.release(sid)
    return res


def decode_from(backend, sid, out, step):
    while not out.get("done"):
        out = backend.step_batch([sid], [step])[0]
        step += 1
    return backend.result(sid)


class TestSpeculative:
    def test_bit_identical_to_greedy(self):
        plain = make_backend()
        spec = make_backend(spec_k=4)
        for i in range(3):
            p = {"ids": [1 + ((i * 7 + j) % 126) for j in range(10)]}
            assert drive(plain, f"p{i}", dict(p))["tokens"] == \
                drive(spec, f"s{i}", dict(p))["tokens"]
        st = spec.cache_stats()
        assert st["spec_proposed"] > 0
        assert 0 <= st["spec_accepted"] <= st["spec_proposed"]
        assert spec.cache.stats()["pages_used"] == 0

    def test_multi_token_steps_commit_multiple(self):
        spec = make_backend(spec_k=4)
        out = spec.admit("a", dict(PROMPT))
        steps = tokens = 0
        while not out.get("done"):
            out = spec.step_batch(["a"], [steps])[0]
            steps += 1
            tokens += out.get("n_tokens", 1)
            if out.get("n_tokens", 1) > 1:
                assert out["tokens"][-1] == out["token"]
        assert tokens > steps
        spec.release("a")

    def test_replayed_spec_step_returns_memo(self):
        spec = make_backend(spec_k=4)
        spec.admit("a", dict(PROMPT))
        first = spec.step_batch(["a"], [0])[0]
        assert spec.step_batch(["a"], [0])[0] == first
        spec.release("a")

    def test_near_max_len_clamps_draft_block(self):
        spec = make_backend(spec_k=4, max_len=32, max_new_tokens=64,
                            num_pages=8)
        res = drive(spec, "edge", {"ids": [3] * 28})
        assert len(res["tokens"]) <= 32
        spec._prefix.clear()
        assert spec.cache.stats()["pages_used"] == 0

    def test_drafter_proposes_from_the_history(self):
        from tosem_tpu_torch.serve.backends import NGramDrafter
        d = NGramDrafter()
        assert d.propose([1, 2, 3, 1, 2], 3) == [3, 1, 2]   # bigram
        assert d.propose([5, 9, 5], 2) == [9, 5]            # unigram
        assert d.propose([4, 7], 2) == [7, 7]               # repeat-last
        assert d.propose([4], 0) == []


class TestWindow:
    def test_bounded_pages_and_eviction(self):
        win = make_backend(**LONG_KW, window=32)
        bound = -(-32 // 16) + 2
        out = win.admit("w", dict(PROMPT))
        step, max_seen = 0, 0
        while not out.get("done"):
            out = win.step_batch(["w"], [step])[0]
            step += 1
            max_seen = max(max_seen, win.cache.stats()["pages_used"])
        assert max_seen <= bound
        assert win.cache.stats()["pages_evicted_total"] > 0
        win.release("w")
        assert win.cache.stats()["pages_used"] == 0

    def test_window_covering_history_matches_unwindowed(self):
        plain = make_backend()
        win = make_backend(window=DECODE_KW["max_len"])
        assert drive(plain, "p", dict(PROMPT))["tokens"] == \
            drive(win, "w", dict(PROMPT))["tokens"]

    def test_window_spec_composition_matches_windowed_greedy(self):
        ws = make_backend(**LONG_KW, window=32, spec_k=4)
        wo = make_backend(**LONG_KW, window=32)
        assert drive(ws, "ws", dict(PROMPT))["tokens"] == \
            drive(wo, "wo", dict(PROMPT))["tokens"]

    def test_eviction_never_outruns_the_kernel_window(self):
        win = make_backend(**LONG_KW, window=32)
        out = win.admit("w", dict(PROMPT))
        step = 0
        while not out.get("done"):
            needed_low = max(len(win._seqs["w"].tokens) - 32, 0)
            cached_low = win.cache.page_offset("w") * win.page_size
            assert cached_low <= needed_low, step
            out = win.step_batch(["w"], [step])[0]
            step += 1
        win.release("w")

    def test_long_prompt_prefills_through_the_band(self):
        """A prompt longer than the window prefills through the band and
        releases its leading pages at admit; with history outside the
        window, its stream is not the unwindowed one."""
        win = make_backend(**LONG_KW, window=32)
        plain = make_backend(**LONG_KW)
        prompt = {"ids": [1 + ((3 * j) % 120) for j in range(100)],
                  "max_new_tokens": 8}
        out = win.admit("w", dict(prompt))
        assert win.cache.page_offset("w") > 0
        assert len(win.cache.pages_of("w")) <= -(-32 // 16) + 2
        a = decode_from(win, "w", out, 0)["tokens"]
        assert a != drive(plain, "p", dict(prompt))["tokens"]
        win.release("w")

    def test_unrecoverable_reprefill_fails_terminally(self):
        from tosem_tpu_torch.serve.kv_cache import (LocalSpillStore,
                                                    PagesLostError)
        b = make_backend(max_batch=4, max_len=256, page_size=8,
                         num_pages=8, max_new_tokens=80, window=16)
        b.cache._spill_store = LocalSpillStore()
        drive_out = b.admit("w", dict(PROMPT))
        decode_from(b, "w", drive_out, 0)
        assert len(b._seqs["w"].tokens) > 64   # re-prefill needs > pool
        b.spill_seq("w")
        b.cache._spill_store._data.clear()     # chaos: payload gone
        with pytest.raises(PagesLostError, match="unrecoverable"):
            b.restore_seq("w")
        b.release("w")

    def test_windowed_spill_restore_mid_decode(self):
        win = make_backend(**LONG_KW, window=32)
        out = win.admit("w", dict(PROMPT))
        step = 0
        while not out.get("done"):
            if step == 40:
                assert win.cache.page_offset("w") > 0
                win.spill_seq("w")
                assert win.cache.is_spilled("w")
                win.restore_seq("w")
            out = win.step_batch(["w"], [step])[0]
            step += 1
        toks = win.result("w")["tokens"]
        win.release("w")
        ref = make_backend(**LONG_KW, window=32)
        assert toks == drive(ref, "x", dict(PROMPT))["tokens"]

    def test_windowed_prefill_pads_to_the_flash_tiles(self):
        """The windowed prefill runs B1's schedule mode, whose 64-row
        tiles must divide the length on the card: its bucket is a page
        multiple rounded up to 64 where ``max_len`` allows, the page
        multiple otherwise; an unwindowed bucket stays the page
        multiple."""
        win = make_backend(window=32, max_len=96)
        assert win._prefill_bucket(20) == 64
        assert win._prefill_bucket(70) == 80       # 128 > max_len
        assert make_backend(max_len=96)._prefill_bucket(20) == 32

    def test_bad_window_and_spec_settings_rejected(self):
        for kw in (dict(window=0), dict(spec_k=9),
                   dict(window=2, spec_k=4)):
            with pytest.raises(ValueError):
                make_backend(**kw)
        assert make_backend(window=8)._prefix is None


class TestGroups:
    def test_beam_result_sorted_and_best_at_least_greedy(self):
        b = make_backend()
        res = drive(b, "g", {**PROMPT, "n": 4, "beam": True})
        assert len(res["beams"]) == 4
        lps = [e["logprob"] for e in res["beams"]]
        assert lps == sorted(lps, reverse=True)
        assert all(math.isfinite(lp) for lp in lps)
        assert res["tokens"] == res["beams"][0]["tokens"]
        assert b.cache.stats()["pages_used"] == 0

    def test_group_shares_prefix_pages(self):
        b = make_backend()
        long_prompt = {"ids": [1 + (j % 126) for j in range(48)]}
        b.admit("s", dict(long_prompt))
        single = b.cache.stats()["pages_used"]
        b.admit("g", {**long_prompt, "n": 4, "beam": True})
        assert b.cache.stats()["pages_used"] - single <= 1.5 * single
        b.release("s")
        b.release("g")
        b._prefix.clear()
        assert b.cache.stats()["pages_used"] == 0

    def test_sampling_deterministic_and_isolated(self):
        b = make_backend()
        req = {**PROMPT, "n": 3, "seed": 7, "temperature": 0.9}
        r1 = drive(b, "p1", dict(req))
        r2 = drive(b, "p2", dict(req))
        assert [e["tokens"] for e in r1["samples"]] == \
            [e["tokens"] for e in r2["samples"]]
        g1 = drive(b, "q1", dict(PROMPT))
        assert g1["tokens"] == drive(make_backend(), "q2",
                                     dict(PROMPT))["tokens"]
        assert b.cache.stats()["pages_used"] == 0

    def test_sampling_packed_beside_other_traffic_equals_alone(self):
        req = {**PROMPT, "n": 3, "seed": 7, "temperature": 0.9}
        alone = drive(make_backend(), "s", dict(req))
        b = make_backend()
        b.admit("other", {"ids": [9, 8, 7, 6, 5]})
        out = b.admit("s", dict(req))
        step, live = 0, ["other", "s"]
        while live:
            outs = b.step_batch(live, [step] * len(live))
            live = [s for s, o in zip(live, outs) if not o["done"]]
            step += 1
        assert [e["tokens"] for e in b.result("s")["samples"]] == \
            [e["tokens"] for e in alone["samples"]]
        assert out["n_tokens"] == 3

    def test_group_replay_and_release(self):
        b = make_backend()
        b.admit("g", {**PROMPT, "n": 2, "beam": True})
        first = b.step_batch(["g"], [0])[0]
        assert b.step_batch(["g"], [0])[0] == first
        b.release("g")
        assert b.cache.stats()["pages_used"] == 0

    def test_group_admit_replay_stable_across_beam_transitions(self):
        b = make_backend()
        first = b.admit("g", {**PROMPT, "n": 4, "beam": True})
        for step in range(4):
            b.step_batch(["g"], [step])
        replay = b.admit("g", {**PROMPT, "n": 4, "beam": True})
        assert replay["token"] == first["token"]
        assert replay["done"] is False
        b.release("g")

    def test_oversized_group_rejected(self):
        b = make_backend(max_batch=4)
        with pytest.raises(ValueError, match="max_batch"):
            b.admit("g", {**PROMPT, "n": 8, "beam": True})
        assert b.cache.stats()["pages_used"] == 0

    def test_group_finishing_at_admit_retires_cleanly(self):
        b = make_backend(max_new_tokens=1)
        out = b.admit("g", {**PROMPT, "n": 4, "beam": True})
        assert out["done"]
        assert len(out["result"]["beams"]) == 4
        b.release("g")
        assert b.cache.stats()["pages_used"] == 0

    def test_row_overflow_raises_before_cache_mutation(self):
        b = make_backend(max_batch=2)
        for i in range(2):
            b.admit(f"s{i}", dict(PROMPT))
        b.admit("g", {**PROMPT, "n": 2, "beam": True})
        lengths = {cid: b.cache.length(cid)
                   for cid in ("s0", "s1", "g#0", "g#f1")}
        with pytest.raises(ValueError, match="packed rows"):
            b.step_batch(["s0", "s1", "g"], [0, 0, 0])
        for cid, n in lengths.items():
            assert b.cache.length(cid) == n
        out = b.step_batch(["s0", "s1"], [0, 0])
        assert all("token" in o for o in out)
        for sid in ("s0", "s1", "g"):
            b.release(sid)
        assert b.cache.stats()["pages_used"] == 0


# ------------------------------------- tests/test_decode_serve.py spill

SERVE_KW = dict(max_batch=4, max_len=64, page_size=16, num_pages=24,
                max_new_tokens=6)


class TestSpillMidDecode:
    def test_spill_restore_mid_decode_keeps_tokens(self):
        b = make_backend(**SERVE_KW)
        ref = drive(b, "ref", {"ids": [3, 1, 4, 1, 5]})["tokens"]
        b.admit("s", {"ids": [3, 1, 4, 1, 5]})
        out = b.step_batch(["s"], [0])[0]
        b.spill_seq("s")
        assert b.cache.is_spilled("s")
        b.restore_seq("s")
        assert decode_from(b, "s", out, 1)["tokens"] == ref

    def test_lost_spill_payload_reprefills_bit_consistently(self):
        from tosem_tpu_torch.serve.kv_cache import LocalSpillStore
        store = LocalSpillStore()
        b = make_backend(**SERVE_KW)
        b.cache._spill_store = store
        ref = drive(b, "ref", {"ids": [2, 7, 1, 8]})["tokens"]
        b.admit("s", {"ids": [2, 7, 1, 8]})
        out = b.step_batch(["s"], [0])[0]
        b.spill_seq("s")
        store._data.clear()                 # chaos: payload evicted
        b.restore_seq("s")                  # falls back to re-prefill
        assert decode_from(b, "s", out, 1)["tokens"] == ref

    def test_lost_payload_restore_under_pressure_stays_coherent(self):
        from tosem_tpu_torch.serve.kv_cache import (CachePressure,
                                                    LocalSpillStore)
        store = LocalSpillStore()
        b = make_backend(**dict(SERVE_KW, num_pages=2))
        b.cache._spill_store = store
        ref = drive(make_backend(**SERVE_KW), "ref",
                    {"ids": [2, 7, 1, 8]})["tokens"]
        b.admit("s", {"ids": [2, 7, 1, 8]})
        out = b.step_batch(["s"], [0])[0]
        b.spill_seq("s")
        store._data.clear()
        b.admit("hog", {"ids": [1] * 17})   # both pages taken
        with pytest.raises(CachePressure):
            b.restore_seq("s")
        assert b.cache.is_spilled("s")      # still parked, retryable
        b.release("hog")
        b.restore_seq("s")
        assert decode_from(b, "s", out, 1)["tokens"] == ref


# --------------------------------------- tests/test_prefix_cache.py:240

SHARED = [1 + (5 * j) % 97 for j in range(32)]
SESSION_KW = dict(max_batch=4, max_len=96, page_size=16, num_pages=48,
                  max_new_tokens=8)


def test_session_turn2_prefills_only_the_suffix():
    warm = make_backend(**SESSION_KW)
    cold = make_backend(prefix_cache=False, **SESSION_KW)
    hist = drive(warm, "t1", {"ids": SHARED[:20],
                              "session": "chat"})["tokens"]
    ids2 = hist + [9, 9]
    before = warm.cache_stats()
    res2 = drive(warm, "t2", {"ids": ids2, "session": "chat"})
    after = warm.cache_stats()
    assert after["prefill_tokens"] - before["prefill_tokens"] == \
        len(ids2) - (len(hist) - 1)
    assert after["session_hits"] == before["session_hits"] + 1
    assert after["sessions"] == 1
    assert drive(cold, "ref2", {"ids": ids2})["tokens"] == res2["tokens"]


def test_sessions_spill_first_under_pressure_and_resume():
    """Pool pressure spills the LRU session's stash before anything
    else; its next turn restores it and still prefills only the
    suffix."""
    b = make_backend(**dict(SESSION_KW, num_pages=6), prefix_cache=False)
    hist = drive(b, "t1", {"ids": SHARED[:20], "session": "s"})["tokens"]
    cid = b._sessions["s"]["cid"]
    drive(b, "hog", {"ids": [1] * 60})      # needs 4 of the 6 pages
    assert b.cache.is_spilled(cid)
    before = b.cache_stats()["prefill_tokens"]
    res = drive(b, "t2", {"ids": hist + [3], "session": "s"})
    assert b.cache_stats()["prefill_tokens"] - before == 2
    cold = make_backend(**SESSION_KW, prefix_cache=False)
    assert res["tokens"] == drive(cold, "c", {"ids": hist + [3]})["tokens"]


# ------------------------------------ tests/test_kv_migration.py backend

MIG_KW = dict(max_batch=4, max_len=64, page_size=16, num_pages=24,
              max_new_tokens=8)
MIG_PROMPT = {"ids": [1, 2, 3, 4]}


class TestBackendMigration:
    @pytest.fixture(scope="class")
    def reference_tokens(self):
        return drive(make_backend(**MIG_KW), "ref",
                     dict(MIG_PROMPT))["tokens"]

    def test_greedy_migration_bit_identical(self, reference_tokens):
        src, dst = make_backend(**MIG_KW), make_backend(**MIG_KW)
        out = src.admit("s", dict(MIG_PROMPT))
        for st in range(2):
            out = src.step_batch(["s"], [st])[0]
        dst.import_seq("s", src.export_seq("s"))
        src.release("s")
        assert decode_from(dst, "s", out, 2)["tokens"] == reference_tokens

    def test_mid_spill_backend_migration(self, reference_tokens):
        src, dst = make_backend(**MIG_KW), make_backend(**MIG_KW)
        src.admit("s", dict(MIG_PROMPT))
        out = src.step_batch(["s"], [0])[0]
        src.spill_seq("s")
        dst.import_seq("s", src.export_seq("s"))
        src.release("s")
        assert decode_from(dst, "s", out, 1)["tokens"] == reference_tokens

    def test_export_at_admit_hands_off_and_replays(self,
                                                   reference_tokens):
        """The prefill tier's ``admit(export=True)``: the outcome carries
        the state, the source keeps nothing, and a replayed admit returns
        the recorded outcome without its state."""
        src, dst = make_backend(**MIG_KW), make_backend(**MIG_KW)
        out = src.admit("s", dict(MIG_PROMPT), export=True)
        assert src.list_seqs() == []
        assert src.cache.stats()["sequences"] == 0
        replay = src.admit("s", dict(MIG_PROMPT), export=True)
        assert "state" not in replay and replay["token"] == out["token"]
        dst.import_seq("s", out.pop("state"))
        assert decode_from(dst, "s", out, 0)["tokens"] == reference_tokens

    def test_beam_group_migration_bit_identical(self):
        req = {"ids": [5, 6, 7], "n": 3, "beam": True}
        want = drive(make_backend(**MIG_KW), "g", dict(req))
        src, dst = make_backend(**MIG_KW), make_backend(**MIG_KW)
        src.admit("g", dict(req))
        out = src.step_batch(["g"], [0])[0]
        dst.import_seq("g", src.export_seq("g"))
        src.release("g")
        assert decode_from(dst, "g", out, 1) == want

    def test_windowed_migration_bit_identical(self):
        kw = dict(max_batch=4, max_len=96, page_size=8, num_pages=48,
                  max_new_tokens=10, window=24)
        prompt = {"ids": list(range(1, 30))}
        want = drive(make_backend(**kw), "w", dict(prompt))["tokens"]
        src, dst = make_backend(**kw), make_backend(**kw)
        out = src.admit("w", dict(prompt))
        for st in range(3):
            out = src.step_batch(["w"], [st])[0]
        dst.import_seq("w", src.export_seq("w"))
        src.release("w")
        assert decode_from(dst, "w", out, 3)["tokens"] == want

    def test_list_seqs_and_release(self):
        b = make_backend(**MIG_KW)
        assert b.list_seqs() == []
        b.admit("s1", dict(MIG_PROMPT))
        b.admit("s2", {"ids": [9, 8, 7]})
        assert b.list_seqs() == ["s1", "s2"]
        b.release("s1")
        assert b.list_seqs() == ["s2"]

    def test_per_request_token_budget(self):
        b = make_backend(**MIG_KW)
        assert len(b.call({"ids": [1, 2, 3],
                           "max_new_tokens": 3})["generated"]) == 3
        assert len(b.call({"ids": [1, 2, 3],
                           "max_new_tokens": 1})["generated"]) == 1
        with pytest.raises(ValueError):
            b.admit("bad", {"ids": [1, 2, 3], "max_new_tokens": 0})
        res = b.call({"ids": [1, 2, 3], "max_new_tokens": 999})
        assert len(res["generated"]) == MIG_KW["max_new_tokens"]

    def test_budget_survives_migration(self):
        req = {"ids": [1, 2, 3], "max_new_tokens": 4}
        want = drive(make_backend(**MIG_KW), "b", dict(req))["tokens"]
        src, dst = make_backend(**MIG_KW), make_backend(**MIG_KW)
        src.admit("b", dict(req))
        out = src.step_batch(["b"], [0])[0]
        dst.import_seq("b", src.export_seq("b"))
        src.release("b")
        got = decode_from(dst, "b", out, 1)
        assert got["tokens"] == want and len(got["generated"]) == 4

    def test_step_on_unadopted_seq_reports_pending(self):
        b = make_backend(**MIG_KW)
        assert b.step_batch(["ghost"], [0])[0] == {"pending": True}

    def test_session_stashes_move_between_backends(self):
        src, dst = make_backend(**SESSION_KW), make_backend(**SESSION_KW)
        hist = drive(src, "t1", {"ids": SHARED[:20],
                                 "session": "k"})["tokens"]
        for key, state in src.export_sessions().items():
            dst.import_session(key, state)
        res = drive(dst, "t2", {"ids": hist + [4], "session": "k"})
        assert dst.cache_stats()["session_hits"] == 1
        cold = make_backend(prefix_cache=False, **SESSION_KW)
        assert res["tokens"] == drive(cold, "c",
                                      {"ids": hist + [4]})["tokens"]


def test_streamed_handoff_waits_for_the_transport():
    """The port has no transport yet: no ``send_seq`` or
    ``transport_address`` (so ``DecodeQueue`` hands prefilled sequences
    off by export), and ``admit(send_to=...)`` raises naming A11 before
    it allocates anything."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    for name in ("send_seq", "adopt_seq", "transport_address",
                 "send_prefix", "adopt_prefix"):
        assert not hasattr(BertDecodeBackend, name)
    b = make_backend(**MIG_KW)
    with pytest.raises(NotImplementedError, match="A11"):
        b.admit("s", dict(MIG_PROMPT), send_to="tcp://peer")
    assert b.cache.stats()["pages_used"] == 0


# ----------------------------------------------------- across packages


@pytest.fixture
def fp32_configs(monkeypatch):
    """Both packages' tiny decoders built at float32 (see the module
    docstring)."""
    import tosem_tpu.models.bert as jbert
    import tosem_tpu_torch.models.bert as tbert

    @dataclasses.dataclass(frozen=True)
    class RefConfig32(jbert.BertConfig):
        dtype: str = "float32"

    @dataclasses.dataclass(frozen=True)
    class PortConfig32(tbert.BertConfig):
        dtype: str = "float32"

    monkeypatch.setattr(jbert, "BertConfig", RefConfig32)
    monkeypatch.setattr(tbert, "BertConfig", PortConfig32)


def _pair(**kw):
    """The JAX package's tiny backend and the port's with its weights."""
    import jax
    from tosem_tpu.serve.backends import BertDecodeBackend as JDec
    ref = JDec(**kw)
    assert ref.cfg.dtype == "float32"
    params = jax.tree_util.tree_map(np.asarray, ref._vs["params"])
    port = make_backend(params=params, **kw)
    assert port.cfg.dtype == "float32"
    return ref, port


XPKG_KW = dict(max_batch=8, max_len=256, page_size=16, num_pages=96,
               max_new_tokens=40)
XPKG_PROMPT = {"ids": [1 + ((7 + j) % 126) for j in range(40)]}


@pytest.mark.parametrize("mode", [dict(window=32),
                                  dict(window=32, spec_k=4),
                                  dict(spec_k=4)],
                         ids=["window", "window+spec", "spec"])
def test_streams_equal_the_reference(fp32_configs, mode):
    ref, port = _pair(**XPKG_KW, **mode)
    want = drive(ref, "a", dict(XPKG_PROMPT))
    got = drive(port, "a", dict(XPKG_PROMPT))
    assert got["tokens"] == want["tokens"]
    if "window" in mode:
        assert port.cache.stats()["pages_evicted_total"] == \
            ref.cache.stats()["pages_evicted_total"] > 0
    if "spec_k" in mode:
        for key in ("spec_proposed", "spec_accepted"):
            assert port.cache_stats()[key] == ref.cache_stats()[key]


def test_beam_best_branch_and_scores_equal_the_reference(fp32_configs):
    ref, port = _pair(**XPKG_KW)
    req = {**XPKG_PROMPT, "n": 4, "beam": True}
    want = drive(ref, "g", dict(req))
    got = drive(port, "g", dict(req))
    assert got["tokens"] == want["tokens"]
    assert len(got["beams"]) == len(want["beams"]) == 4
    for g, w in zip(got["beams"], want["beams"]):
        assert abs(g["logprob"] - w["logprob"]) <= 1e-4


def test_session_turn2_equals_the_reference(fp32_configs):
    ref, port = _pair(**SESSION_KW)
    streams, prefilled = [], []
    for b in (ref, port):
        hist = drive(b, "t1", {"ids": SHARED[:20],
                               "session": "chat"})["tokens"]
        before = b.cache_stats()["prefill_tokens"]
        streams.append(drive(b, "t2", {"ids": hist + [9, 9],
                                       "session": "chat"})["tokens"])
        prefilled.append(b.cache_stats()["prefill_tokens"] - before)
        assert b.cache_stats()["session_hits"] == 1
    assert streams[0] == streams[1]
    assert prefilled[0] == prefilled[1] == 3
