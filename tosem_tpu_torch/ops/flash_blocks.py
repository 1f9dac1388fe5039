"""Tile sizes of the flash kernel, and the decode kernels' page size and
speculative block with their autotune cache.

The CUDA flash kernels have fixed tiles. The forward
(``csrc/flash_fwd.cu``) runs :data:`FLASH_BQ` query rows a block and
streams K/V in :data:`FLASH_BK`-key tiles through shared memory; both
backward kernels (``csrc/flash_bwd.cu``) keep :data:`FLASH_BQ_BWD` (dQ)
or :data:`FLASH_BK_BWD` (dK/dV) resident rows a block and stream the
other side in tiles of the same size. There is no VMEM budget and no
autotune of those tiles yet; :class:`BlockSizes` only names them, and
:func:`select_block_sizes` returns them, so that a FLOP model
(``ops/kernel_suite.py``) counts the tiles the kernels really skip.

:func:`select_page_size` and :func:`select_spec_q` keep the JAX
package's tables, defaults and clamps, and read an autotune cache first,
as it does (JSON, sections ``"pages"`` and ``"decode"``), whose keys are
scoped ``{platform}/{backend}/{shape key}``, so a winner
is only ever read on the (platform, kernel backend) that measured it.
The platform is the port's own (``cuda`` or ``cpu``) and the backend
the registry's (``cuda`` or ``torch``), so a cache never mixes the two
packages' winners; the default file is the port's own,
:data:`DEFAULT_CACHE_PATH`, never the JAX package's
``results/flash_blocks.json``. :func:`autotune_decode_pages` and
:func:`autotune_spec_q` time B4 and B5 on the caller's device by
:class:`~tosem_tpu_torch.utils.timing.DeviceLoopBench` (graph replay on
the card) and write the winners there. A corrupt or missing file, or a
corrupt section or entry, degrades to the table. The flash tiles' half
(``blocks`` and ``sparse`` sections, their sweeps) waits for a kernel
body with tiles to choose (ROADMAP.md A4).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

_SUBLANES = 8

FLASH_BQ = 64
FLASH_BK = 64
FLASH_BQ_BWD = 64   # flash_bwd.cu BR / BS: query rows of a dQ block
FLASH_BK_BWD = 64   # key rows of a dK/dV block


@dataclass(frozen=True)
class BlockSizes:
    """The kernels' tiles: ``bq`` query rows per forward block, ``bk``
    keys per streamed forward tile; ``bq_bwd``/``bk_bwd`` the query and
    key tiles of both backward kernels."""
    bq: int = FLASH_BQ
    bk: int = FLASH_BK
    bq_bwd: int = FLASH_BQ_BWD
    bk_bwd: int = FLASH_BK_BWD

    def as_list(self) -> List[int]:
        return [self.bq, self.bk, self.bq_bwd, self.bk_bwd]


def select_block_sizes(Tq: int, d: int, dtype: str,
                       Tk: Optional[int] = None, *,
                       mask_sig: Optional[str] = None,
                       backend: Optional[str] = None) -> BlockSizes:
    """The CUDA kernels' tiles for a (T, d, dtype) configuration. They
    are fixed, so every configuration gets the same tiles; a causal
    kernel skips the (64, 64) tile pairs past the diagonal whatever T
    is, and a mask program is compiled at these tiles. ``mask_sig`` and
    ``backend`` are the JAX package's keys of its sparse autotune cache;
    there is no such cache here yet, so they change nothing. Sets
    ``select_block_sizes.last_source`` to ``"fixed"``."""
    select_block_sizes.last_source = "fixed"
    return BlockSizes()


select_block_sizes.last_source = "fixed"


# ---------------------------------------------------------------------------
# the autotune cache of the decode selectors

# relative to the working directory, as the JAX package's cache is
DEFAULT_CACHE_PATH = os.path.join("results", "flash_blocks_torch.json")


def _valid_scalar_value(v) -> bool:
    """A scalar-valued entry (both sections)."""
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and int(v) > 0)


# section -> (value validator, coercer, kernel family whose default
# backend scopes unqualified reads and writes)
_SECTIONS = {
    "pages": (_valid_scalar_value, int, "paged"),
    "decode": (_valid_scalar_value, int, "paged"),
}


def _check_section(section: str) -> None:
    if section not in _SECTIONS:
        raise ValueError(f"unknown cache section {section!r}; expected "
                         f"one of {tuple(_SECTIONS)}")


def current_platform() -> str:
    """The platform an unqualified selector reads for: ``"cuda"`` when a
    card is present (the port's entry points run there), else
    ``"cpu"``."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def cache_scope(section: str, platform: Optional[str] = None,
                backend: Optional[str] = None) -> str:
    """``"{platform}/{backend}"`` prefix of a section's keys. Defaults:
    :func:`current_platform`, and the backend the registry serves the
    section's kernel family with there (``cuda`` on the card, ``torch``
    on the CPU). An explicit backend must run on the platform."""
    from tosem_tpu_torch.ops import registry
    _check_section(section)
    platform = platform or current_platform()
    backend = registry.resolve(_SECTIONS[section][2], backend,
                               platform=platform)
    return f"{platform}/{backend}"


def scoped_key(section: str, key: str, platform: Optional[str] = None,
               backend: Optional[str] = None) -> str:
    return f"{cache_scope(section, platform, backend)}/{key}"


class _CacheStore:
    """In-process view of one JSON cache file: every section loaded and
    validated once per path, dropped by :func:`reset_cache` and replaced
    by a :func:`save_cache` write. A corrupt file, section or entry
    degrades to the table for that key; an unscoped key is dropped."""

    def __init__(self) -> None:
        self.path: Optional[str] = None
        self.sections: Dict[str, dict] = {}

    def _validate(self, raw: dict) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for name, (valid, coerce, _) in _SECTIONS.items():
            section = raw.get(name, {})
            if not isinstance(section, dict):
                out[name] = {}
                continue
            out[name] = {k: coerce(v) for k, v in section.items()
                         if isinstance(k, str) and k.count("/") >= 2
                         and valid(v)}
        return out

    def load(self, path: str) -> Dict[str, dict]:
        if self.path != path or not self.sections:
            try:
                with open(path) as f:
                    raw = json.load(f)
                if not isinstance(raw, dict):
                    raw = {}
            except (OSError, ValueError):
                raw = {}
            self.sections = self._validate(raw)
            self.path = path
        return self.sections

    def get(self, path: str, section: str, key: str,
            platform: Optional[str], backend: Optional[str]):
        _check_section(section)
        return self.load(path)[section].get(
            scoped_key(section, key, platform, backend))

    def save(self, winners: dict, path: str, section: str,
             platform: Optional[str], backend: Optional[str]) -> None:
        _check_section(section)
        scope = cache_scope(section, platform, backend)
        sections = {n: dict(s) for n, s in self.load(path).items()}
        sections[section].update(
            {f"{scope}/{k}": v for k, v in winners.items()})
        payload = {n: s for n, s in sections.items() if s}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.sections = sections
        self.path = path

    def reset(self) -> None:
        self.path = None
        self.sections = {}


_STORE = _CacheStore()


def save_cache(winners: Dict[str, int],
               cache_path: str = DEFAULT_CACHE_PATH, *,
               section: str = "pages", platform: Optional[str] = None,
               backend: Optional[str] = None) -> None:
    """Merge winners into the JSON cache (atomic write; the other
    section survives). ``section`` is ``"pages"`` (page sizes) or
    ``"decode"`` (speculative q rows); winner keys are plain shape keys,
    written under the ``{platform}/{backend}`` scope (defaults: this
    process's)."""
    _STORE.save(winners, cache_path, section, platform, backend)


def reset_cache() -> None:
    """Drop the in-process cache view (tests; after external writes)."""
    _STORE.reset()


def _sweep_scope(backend: Optional[str], device) -> Tuple[str, str, object]:
    """(platform, backend, device) a sweep measures under: the scope its
    records carry and its winners are written to."""
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.ops.common import resolve_device
    dev = resolve_device(device)
    backend = registry.resolve("paged", backend, platform=dev.type)
    return dev.type, backend, dev


def _paged_operands(B: int, H: int, T: int, d: int, dtype: str, page: int,
                    dev, k_rows: int = 0):
    """q ([B, H, d], or [B, k_rows, H, d]), pools holding every
    sequence's T keys in its own pages, the identity block tables and
    full lengths: seeded on the CPU, then moved to ``dev``."""
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    n_pages = T // page
    P = B * n_pages
    shape = (B, k_rows, H, d) if k_rows else (B, H, d)
    q = torch.randn(shape, generator=g).to(dev, dt)
    kp = torch.randn((P, page, H, d), generator=g).to(dev, dt)
    vp = torch.randn((P, page, H, d), generator=g).to(dev, dt)
    bt = torch.arange(P, dtype=torch.int32).reshape(B, n_pages).to(dev)
    sl = torch.full((B,), T, dtype=torch.int32).to(dev)
    return q, kp, vp, bt, sl


# (d, dtype) -> KV page size of the paged decode kernels (the JAX
# package's table: 128 tokens per page)
DECODE_PAGE_TABLE: Dict[Tuple[int, str], int] = {
    (64, "bfloat16"): 128,
    (64, "float32"): 128,
}

_DEFAULT_PAGE = 128

_PAGE_CANDIDATES = (64, 128, 256, 512)


def _page_key(d: int, dtype: str) -> str:
    return f"decode_d{d}_{dtype}"


def select_page_size(d: int, dtype: str, *, max_len: Optional[int] = None,
                     cache_path: Optional[str] = DEFAULT_CACHE_PATH,
                     platform: Optional[str] = None,
                     backend: Optional[str] = None) -> int:
    """Page size for a (d, dtype) decode configuration: the autotune
    cache's ``"pages"`` section (scoped ``{platform}/{backend}``), else
    the table, else the default; then halved while it exceeds
    ``max_len``, floored at 8. ``cache_path`` None reads no cache. Sets
    ``select_page_size.last_source`` (``cache``, ``table`` or
    ``default``)."""
    dtype = str(dtype).replace("torch.", "")
    picked: Optional[int] = None
    src = "default"
    if cache_path:
        hit = _STORE.get(cache_path, "pages", _page_key(d, dtype), platform,
                         backend)
        if hit:
            picked, src = int(hit), "cache"
    if picked is None:
        hit = DECODE_PAGE_TABLE.get((d, dtype))
        picked, src = (int(hit), "table") if hit is not None \
            else (_DEFAULT_PAGE, "default")
    if max_len is not None:
        while picked > _SUBLANES and picked > max_len:
            picked //= 2
    select_page_size.last_source = src
    return max(picked, _SUBLANES)


select_page_size.last_source = "default"


def autotune_decode_pages(shapes: Iterable[Tuple[int, int, int, int, str]],
                          *, reps: int = 3,
                          cache_path: str = DEFAULT_CACHE_PATH,
                          backend: Optional[str] = None,
                          device="cuda") -> List[dict]:
    """Time B4 (``paged_decode``) at each candidate page size and cache
    the winners in the ``"pages"`` section, where
    :func:`select_page_size` (and so ``BertDecodeBackend``) reads them.

    ``shapes``: (B, H, T, d, dtype), T the cached context of every
    sequence; a page that does not divide T is skipped. Each call is
    timed by :class:`~tosem_tpu_torch.utils.timing.DeviceLoopBench` on
    ``device`` (graph replay on the card; the host clock for the plain
    version on the CPU). Winners are keyed (d, dtype), the selector's
    key, so when several shapes share one the FIRST shape's winner
    sticks: order the sweep north-star shape first. Returns one record
    per timed candidate."""
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    from tosem_tpu_torch.utils.timing import DeviceLoopBench

    platform, backend, dev = _sweep_scope(backend, device)
    records: List[dict] = []
    winners: Dict[str, int] = {}
    for B, H, T, d, dtype in shapes:
        best = None
        timed = []
        for page in _PAGE_CANDIDATES:
            if page > T or T % page:
                continue
            q, kp, vp, bt, sl = _paged_operands(B, H, T, d, str(dtype),
                                                page, dev)

            def op(q, kp, vp, bt=bt, sl=sl):
                return paged_attention(q, kp, vp, bt, sl, backend=backend)
            sec = DeviceLoopBench(op=op, args=(q, kp, vp)).time(reps=reps)
            del q, kp, vp
            timed.append((page, sec))
            if best is None or sec < best[1]:
                best = (page, sec)
        for page, sec in timed:
            records.append({"shape": [B, H, T, d, str(dtype)],
                            "page": page, "time_us": sec * 1e6,
                            "backend": backend, "platform": platform,
                            "best": page == best[0]})
        if best is not None:
            winners.setdefault(_page_key(d, str(dtype)), best[0])
    if winners:
        save_cache(winners, cache_path, section="pages",
                   platform=platform, backend=backend)
    return records


# ---------------------------------------------------------------------------
# multi-token decode q rows (speculative scoring)

# (d, dtype) -> draft block k of a speculative step (the JAX package's
# table): k rows ride one B5 launch
DECODE_SPEC_Q_TABLE: Dict[Tuple[int, str], int] = {
    (64, "bfloat16"): 4,
    (64, "float32"): 4,
}

_DEFAULT_SPEC_Q = 4

_SPEC_Q_CANDIDATES = (2, 4, 8)


def _spec_q_key(d: int, dtype: str) -> str:
    return f"spec_q_d{d}_{dtype}"


def select_spec_q(d: int, dtype: str, *,
                  cache_path: Optional[str] = DEFAULT_CACHE_PATH,
                  platform: Optional[str] = None,
                  backend: Optional[str] = None) -> int:
    """The draft block (q rows a speculative step scores) for a
    (d, dtype) decode configuration: the cache's ``"decode"`` section
    (scoped like every section), else the table, else the default;
    clamped into [1, 8] as in the JAX package. Sets
    ``select_spec_q.last_source``."""
    dtype = str(dtype).replace("torch.", "")
    picked: Optional[int] = None
    src = "default"
    if cache_path:
        hit = _STORE.get(cache_path, "decode", _spec_q_key(d, dtype), platform,
                         backend)
        if hit:
            picked, src = int(hit), "cache"
    if picked is None:
        hit = DECODE_SPEC_Q_TABLE.get((d, dtype))
        picked, src = (int(hit), "table") if hit is not None \
            else (_DEFAULT_SPEC_Q, "default")
    select_spec_q.last_source = src
    return max(1, min(picked, _SUBLANES))


select_spec_q.last_source = "default"


def autotune_spec_q(shapes: Iterable[Tuple[int, int, int, int, str]],
                    *, reps: int = 3,
                    ks: Tuple[int, ...] = _SPEC_Q_CANDIDATES,
                    cache_path: str = DEFAULT_CACHE_PATH,
                    backend: Optional[str] = None,
                    device="cuda") -> List[dict]:
    """Time B5 (``paged_decode_multi``) at each candidate k and cache
    the winners in the ``"decode"`` section, where :func:`select_spec_q`
    reads them. Candidates are scored on time per scored token (step
    time / k), so a k that only wins by batching more rows loses. The
    page is :func:`select_page_size`'s for the shape (this cache's
    winner when it has one), halved until it divides T. Winners are
    keyed (d, dtype): the first shape sticks."""
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    from tosem_tpu_torch.utils.timing import DeviceLoopBench

    platform, backend, dev = _sweep_scope(backend, device)
    records: List[dict] = []
    winners: Dict[str, int] = {}
    for B, H, T, d, dtype in shapes:
        page = select_page_size(d, str(dtype), max_len=T,
                                cache_path=cache_path,
                                platform=platform, backend=backend)
        page = min(page, T)
        while T % page:
            page //= 2
        best = None
        timed = []
        for k in ks:
            if not 1 <= k <= _SUBLANES:
                continue
            q, kp, vp, bt, sl = _paged_operands(B, H, T, d, str(dtype),
                                                page, dev, k_rows=k)

            def op(q, kp, vp, bt=bt, sl=sl):
                return paged_attention(q, kp, vp, bt, sl, backend=backend)
            sec = DeviceLoopBench(op=op, args=(q, kp, vp)).time(reps=reps)
            del q, kp, vp
            timed.append((k, sec))
            if best is None or sec / k < best[1] / best[0]:
                best = (k, sec)
        for k, sec in timed:
            records.append({"shape": [B, H, T, d, str(dtype)], "k": k,
                            "page": page, "time_us": sec * 1e6,
                            "per_token_us": sec * 1e6 / k,
                            "backend": backend, "platform": platform,
                            "best": k == best[0]})
        if best is not None:
            winners.setdefault(_spec_q_key(d, str(dtype)), best[0])
    if winners:
        save_cache(winners, cache_path, section="decode",
                   platform=platform, backend=backend)
    return records
