"""The decode half of block selection (``ops/flash_blocks.py``): the page
and speculative-block selectors, their scoped autotune cache and the two
sweeps, held against the JAX package's ``tosem_tpu.ops.flash_blocks``.

Copies of ``tests/test_flash_blocks.py``'s page and spec-q cases (the
shared section store's corrupt/partial/preserve cases for ``pages`` and
``decode``, the scope checks), ``tests/test_decode_modes.py:492-542``
and ``tests/test_paged_attention.py:141-190``. Each selector case runs
both packages on the same cache contents: the same winners written under
each package's own scope (the reference's ``cpu/xla``, the port's
``cpu/torch``), the same pick and ``last_source`` read back. The sweeps
run the plain version on the CPU here; on the card ``chip_smoke.py``
times B4 and B5.
"""
import json

import pytest

from tosem_tpu.ops import flash_blocks as ref_fb
from tosem_tpu_torch.ops import flash_blocks as fb


@pytest.fixture(autouse=True)
def _fresh_cache():
    fb.reset_cache()
    ref_fb.reset_cache()
    yield
    fb.reset_cache()
    ref_fb.reset_cache()


def _both(tmp_path, write):
    """Two cache files with the same contents, each under its package's
    default scope: ``write(module, path)`` fills one."""
    paths = {}
    for name, mod in (("port", fb), ("ref", ref_fb)):
        path = str(tmp_path / f"{name}.json")
        write(mod, path)
        mod.reset_cache()
        paths[name] = path
    return paths


def _pick(mod, section, path, d=64, dtype="bfloat16", **kw):
    if section == "pages":
        v = mod.select_page_size(d, dtype, cache_path=path, **kw)
        return v, mod.select_page_size.last_source
    v = mod.select_spec_q(d, dtype, cache_path=path, **kw)
    return v, mod.select_spec_q.last_source


def _same_pick(paths, section, **kw):
    got = _pick(fb, section, paths["port"], **kw)
    want = _pick(ref_fb, section, paths["ref"], **kw)
    assert got == want, (section, got, want)
    return got


# ------------------------------------------------------------ the selectors


def test_port_default_cache_is_its_own_file():
    assert fb.DEFAULT_CACHE_PATH == "results/flash_blocks_torch.json"
    assert fb.DEFAULT_CACHE_PATH != ref_fb.DEFAULT_CACHE_PATH


def test_scope_is_the_port_s_platform_and_backend():
    assert fb.cache_scope("pages") == "cpu/torch"
    assert fb.cache_scope("decode", platform="cuda") == "cuda/cuda"
    assert fb.scoped_key("pages", "decode_d64_bfloat16") == \
        "cpu/torch/decode_d64_bfloat16"
    from tosem_tpu_torch.ops.registry import BackendUnavailable
    with pytest.raises(BackendUnavailable):
        fb.cache_scope("pages", platform="cpu", backend="cuda")


@pytest.mark.parametrize("d,dtype,max_len", [
    (64, "bfloat16", None), (96, "float32", None), (64, "bfloat16", 32),
    (64, "bfloat16", 3), (16, "float32", 128)])
def test_select_page_size_table_default_and_clamp(d, dtype, max_len):
    """``test_paged_attention.py``'s table/default/clamp cases."""
    got = fb.select_page_size(d, dtype, max_len=max_len, cache_path=None)
    src = fb.select_page_size.last_source
    want = ref_fb.select_page_size(d, dtype, max_len=max_len,
                                   cache_path=None)
    assert (got, src) == (want, ref_fb.select_page_size.last_source)


def test_select_page_size_takes_torch_dtypes():
    import torch
    assert fb.select_page_size(64, torch.bfloat16, cache_path=None) == 128
    assert fb.select_page_size.last_source == "table"


def test_page_cache_override_and_sections(tmp_path):
    def write(mod, path):
        mod.save_cache({"decode_d64_bfloat16": 256}, path, section="pages")
        mod.save_cache({"spec_q_d64_bfloat16": 8}, path, section="decode")
    paths = _both(tmp_path, write)
    assert _same_pick(paths, "pages") == (256, "cache")
    assert _same_pick(paths, "decode") == (8, "cache")
    # the cached page is clamped like the table's
    assert _same_pick(paths, "pages", max_len=100) == (64, "cache")


def test_spec_q_selector_and_cache_sections(tmp_path):
    """``test_decode_modes.py::test_spec_q_selector_and_cache_sections``
    in both packages."""
    p = str(tmp_path / "fb.json")
    assert fb.select_spec_q(64, "bfloat16", cache_path=p) == 4
    assert fb.select_spec_q.last_source == "table"
    assert fb.select_spec_q(32, "float32", cache_path=p) == 4
    assert fb.select_spec_q.last_source == "default"
    fb.save_cache({"spec_q_d64_bfloat16": 8}, p, section="decode")
    fb.reset_cache()
    assert fb.select_spec_q(64, "bfloat16", cache_path=p) == 8
    assert fb.select_spec_q.last_source == "cache"
    # the other section survives a write
    fb.save_cache({"decode_d64_bfloat16": 256}, p, section="pages")
    fb.reset_cache()
    assert fb.select_spec_q(64, "bfloat16", cache_path=p) == 8
    # a corrupt decode section degrades to the table, never raises
    doc = json.load(open(p))
    doc["decode"] = {"cpu/torch/spec_q_d64_bfloat16": "junk"}
    json.dump(doc, open(p, "w"))
    fb.reset_cache()
    assert fb.select_spec_q(64, "bfloat16", cache_path=p) == 4
    assert fb.select_page_size(64, "bfloat16", cache_path=p) == 256
    # a missing file: defaults
    fb.reset_cache()
    assert fb.select_spec_q(64, "bfloat16",
                            cache_path=str(tmp_path / "no.json")) == 4


@pytest.mark.parametrize("k,want", [(0, 4), (1, 1), (8, 8), (12, 8)])
def test_spec_q_clamps_like_the_reference(tmp_path, k, want):
    def write(mod, path):
        with open(path, "w") as f:
            json.dump({"decode": {mod.scoped_key(
                "decode", "spec_q_d64_bfloat16"): k}}, f)
    paths = _both(tmp_path, write)
    assert _same_pick(paths, "decode")[0] == want


def test_other_scopes_are_never_selected(tmp_path):
    """A winner measured on the card, or by another backend, is never
    read on the CPU's plain version, and vice versa."""
    path = str(tmp_path / "fb.json")
    fb.save_cache({"decode_d64_bfloat16": 256}, path, section="pages",
                  platform="cuda", backend="cuda")
    fb.save_cache({"spec_q_d64_bfloat16": 2}, path, section="decode",
                  platform="cuda")
    fb.reset_cache()
    assert fb.select_page_size(64, "bfloat16", cache_path=path) == 128
    assert fb.select_page_size.last_source == "table"
    assert fb.select_spec_q(64, "bfloat16", cache_path=path) == 4
    assert fb.select_page_size(64, "bfloat16", cache_path=path,
                               platform="cuda") == 256
    assert fb.select_page_size.last_source == "cache"
    assert fb.select_spec_q(64, "bfloat16", cache_path=path,
                            platform="cuda", backend="cuda") == 2


def test_reference_winners_are_never_selected(tmp_path):
    """One file holding the JAX package's winners: its ``cpu/xla`` and
    ``tpu/...`` scopes are not the port's."""
    path = str(tmp_path / "fb.json")
    ref_fb.save_cache({"decode_d64_bfloat16": 256}, path, section="pages")
    ref_fb.save_cache({"decode_d64_bfloat16": 512}, path, section="pages",
                      platform="tpu", backend="pallas-tpu")
    fb.reset_cache()
    assert fb.select_page_size(64, "bfloat16", cache_path=path) == 128
    assert fb.select_page_size.last_source == "table"


def test_legacy_flat_keys_are_dropped(tmp_path):
    def write(mod, path):
        with open(path, "w") as f:
            json.dump({"pages": {"decode_d64_bfloat16": 256},
                       "decode": {"spec_q_d64_bfloat16": 8}}, f)
    paths = _both(tmp_path, write)
    assert _same_pick(paths, "pages") == (128, "table")
    assert _same_pick(paths, "decode") == (4, "table")


@pytest.mark.parametrize("section", ["pages", "decode"])
def test_corrupt_section_degrades_to_table(section, tmp_path):
    def write(mod, path):
        with open(path, "w") as f:
            json.dump({section: "garbage"}, f)
    paths = _both(tmp_path, write)
    assert _same_pick(paths, section)[1] == "table"


@pytest.mark.parametrize("section,key,val", [
    ("pages", "decode_d64_bfloat16", 16),
    ("decode", "spec_q_d64_bfloat16", 2)])
def test_partial_corruption_keeps_good_entries(section, key, val,
                                               tmp_path):
    def write(mod, path):
        mod.save_cache({key: val}, path, section=section)
        raw = json.load(open(path))
        raw[section][mod.scoped_key(section, "bogus_key")] = {"not": 1}
        raw[section][mod.scoped_key(section, "decode_d32_float32")] = -3
        with open(path, "w") as f:
            json.dump(raw, f)
    paths = _both(tmp_path, write)
    assert _same_pick(paths, section) == (val, "cache")


def test_save_preserves_the_other_section(tmp_path):
    path = str(tmp_path / "c.json")
    fb.save_cache({"decode_d64_bfloat16": 16}, path, section="pages")
    fb.save_cache({"spec_q_d64_bfloat16": 2}, path, section="decode")
    raw = json.load(open(path))
    assert raw["pages"][fb.scoped_key("pages", "decode_d64_bfloat16")] == 16
    assert raw["decode"][fb.scoped_key("decode",
                                       "spec_q_d64_bfloat16")] == 2


def test_unknown_section_rejected(tmp_path):
    with pytest.raises(ValueError, match="section"):
        fb.save_cache({"k": 1}, str(tmp_path / "c.json"), section="nope")
    with pytest.raises(ValueError, match="section"):
        fb.cache_scope("blocks")


# ---------------------------------------------------------------- the sweeps


def test_autotune_decode_pages_end_to_end(tmp_path):
    """``test_paged_attention.py::test_autotune_decode_pages_end_to_end``
    (slow there: its CPU lowering is XLA; here the plain version), and
    the winner reaches ``BertDecodeBackend`` through the default path."""
    path = str(tmp_path / "blocks.json")
    recs = fb.autotune_decode_pages([(1, 1, 128, 8, "float32")], reps=1,
                                    cache_path=path, device="cpu")
    assert {r["page"] for r in recs} == {64, 128}
    assert sum(r["best"] for r in recs) == 1
    assert all(r["time_us"] > 0 and r["platform"] == "cpu"
               and r["backend"] == "torch" for r in recs)
    fb.reset_cache()
    best = next(r["page"] for r in recs if r["best"])
    assert fb.select_page_size(8, "float32", cache_path=path) == best
    assert fb.select_page_size.last_source == "cache"


def test_backend_reads_the_cached_page(tmp_path, monkeypatch):
    """``BertDecodeBackend`` reads its page from the default cache, a
    path relative to the working directory."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    monkeypatch.chdir(tmp_path)
    # the tiny decoder: 2 heads of 16, bf16 (BertConfig's default)
    fb.save_cache({"decode_d16_bfloat16": 32}, section="pages")
    assert (tmp_path / fb.DEFAULT_CACHE_PATH).exists()
    fb.reset_cache()
    be = BertDecodeBackend(device="cpu", max_len=128)
    assert be.page_size == 32 and be.cache.page_size == 32
    assert fb.select_page_size.last_source == "cache"
    out = be.call({"ids": [1, 2, 3, 4, 5], "max_new_tokens": 4})
    assert len(out["generated"]) == 4
    fb.reset_cache()
    monkeypatch.chdir(tmp_path / "results")        # no cache here
    assert BertDecodeBackend(device="cpu", max_len=128).page_size == \
        ref_fb.select_page_size(16, "bfloat16", max_len=128,
                                cache_path=None)


def test_autotune_spec_q_end_to_end(tmp_path):
    """``test_decode_modes.py::test_autotune_spec_q_end_to_end``."""
    p = str(tmp_path / "fb.json")
    recs = fb.autotune_spec_q([(1, 1, 64, 16, "float32")], reps=1,
                              ks=(2, 4), cache_path=p, device="cpu")
    assert {r["k"] for r in recs} == {2, 4}
    assert sum(r["best"] for r in recs) == 1
    assert all(r["per_token_us"] > 0 for r in recs)
    fb.reset_cache()
    assert fb.select_spec_q(16, "float32", cache_path=p) in (2, 4)
    assert fb.select_spec_q.last_source == "cache"


def test_sweeps_run_on_the_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        fb.autotune_decode_pages([(1, 1, 64, 16, "float32")], reps=1)
