"""Block-sparse mask programs for the flash kernels.

Counterpart of ``tosem_tpu/ops/mask_programs.py``, of which this module
is a copy (it may not import the JAX package): the same :class:`Mask`
classes with the same ``signature()`` strings, the same
``mask_from_spec`` mini-language, and the same numpy compiler, so a mask
compiles to schedule arrays element-equal to the JAX package's.

A :class:`Mask` is a pure, hashable predicate over (query position, key
position): :class:`FullMask`, :class:`CausalMask`, :class:`LocalMask`
(sliding window), :class:`PrefixLMMask`, :class:`DocumentMask` (static
packed-document ids), composed with ``&`` and per head via
:class:`MultiHeadMask`. It is compiled once per (mask, Tq, Tk, block
sizes) into a :class:`BlockSchedule`: per-head int32 arrays listing, for
every resident tile, the minor-axis block indices to stream (ascending,
the dense loop's order), a full/partial kind per entry, and an index into
a deduplicated pool of (bq, bk) partial-mask bitmaps. The schedule mode
of the CUDA flash kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``)
walks these arrays: skipped blocks cost nothing, full blocks skip the
compare, and only partial blocks read their bitmap.

:func:`program_stats` counts what each schedule executes, which is what
the kernel suite's FLOP model scales by. :func:`schedule_attention_torch`
runs a q-major schedule with plain PyTorch ops (gather exactly the
scheduled K/V blocks, mask, softmax): the counterpart of the JAX
package's ``schedule_attention_xla``.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# schedule entry kinds. 0 marks padded (inactive) trailing entries: the
# kernels stop at ``num``, so kind 0 is never read
KIND_INACTIVE = 0
KIND_FULL = 1
KIND_PARTIAL = 2

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mask objects


class Mask:
    """A static attention mask: a pure predicate over positions.

    Subclasses are frozen dataclasses, so one (mask, shape, blocks) key
    compiles once (``lru_cache``) and the signature string keys dispatch
    tallies stably across processes. ``&`` composes masks by
    intersection."""

    def pattern(self, q_pos: np.ndarray, k_pos: np.ndarray) -> np.ndarray:
        """[len(q_pos), len(k_pos)] bool — True = attend."""
        raise NotImplementedError

    def signature(self) -> str:
        """Stable, process-independent identity string (cache keys)."""
        raise NotImplementedError

    def head_masks(self, heads: Optional[int] = None) -> Tuple["Mask", ...]:
        """Per-head mask tuple: length 1 (uniform: every head shares one
        schedule row) except for :class:`MultiHeadMask`."""
        return (self,)

    def dense(self, Tq: int, Tk: int) -> np.ndarray:
        """[Tq, Tk] bool (uniform) or [H, Tq, Tk] (per head): the
        materialization the plain versions fold into a dense mask."""
        return self.pattern(np.arange(Tq), np.arange(Tk))

    def __and__(self, other: "Mask") -> "Mask":
        # `&` distributes over per-head masks, so causal=True composes
        # with a MultiHeadMask head by head
        if isinstance(other, MultiHeadMask):
            return MultiHeadMask(tuple(self & m for m in other.masks))
        return AndMask((self, other))


@dataclass(frozen=True)
class FullMask(Mask):
    """Every query attends every key. Compiles to an all-FULL schedule."""

    def pattern(self, q_pos, k_pos):
        return np.ones((q_pos.size, k_pos.size), bool)

    def signature(self):
        return "full"


@dataclass(frozen=True)
class CausalMask(Mask):
    """k <= q."""

    def pattern(self, q_pos, k_pos):
        return q_pos[:, None] >= k_pos[None, :]

    def signature(self):
        return "causal"


@dataclass(frozen=True)
class LocalMask(Mask):
    """Sliding window: q - window < k <= q + right.

    ``LocalMask(w)`` is the causal sliding window (each query sees its
    ``w`` most recent keys, itself included); ``LocalMask(w, right=w - 1)``
    is the encoders' band of ``w`` keys on each side, self included."""
    window: int
    right: int = 0

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.right < 0:
            raise ValueError(f"right must be >= 0, got {self.right}")

    def pattern(self, q_pos, k_pos):
        d = q_pos[:, None] - k_pos[None, :]          # q - k
        return (d < self.window) & (d >= -self.right)

    def signature(self):
        return f"local:{self.window}:{self.right}"


@dataclass(frozen=True)
class PrefixLMMask(Mask):
    """Prefix-LM: full attention into the first ``prefix_len`` positions,
    causal after (k < prefix_len or k <= q)."""
    prefix_len: int

    def pattern(self, q_pos, k_pos):
        return (k_pos[None, :] < self.prefix_len) | \
            (q_pos[:, None] >= k_pos[None, :])

    def signature(self):
        return f"prefix:{self.prefix_len}"


@dataclass(frozen=True)
class DocumentMask(Mask):
    """Packed-document mask: position i attends position j iff they
    belong to the same document (``doc_ids[i] == doc_ids[j]``).

    The layout is static, compiled into the schedule; per-request ragged
    boundaries stay dynamic as ``SegmentIds`` (the schedule prunes, the
    segment compare refines inside a block)."""
    doc_ids: Tuple[int, ...]

    def __init__(self, doc_ids):
        object.__setattr__(self, "doc_ids",
                           tuple(int(i) for i in np.asarray(doc_ids)))

    def pattern(self, q_pos, k_pos):
        ids = np.asarray(self.doc_ids)
        if q_pos.max(initial=0) >= ids.size or \
                k_pos.max(initial=0) >= ids.size:
            raise ValueError(
                f"DocumentMask covers {ids.size} positions; asked for "
                f"(q<={int(q_pos.max(initial=0))}, "
                f"k<={int(k_pos.max(initial=0))})")
        return ids[q_pos][:, None] == ids[k_pos][None, :]

    def signature(self):
        h = hashlib.sha1(np.asarray(self.doc_ids,
                                    np.int64).tobytes()).hexdigest()[:12]
        return f"doc:{len(self.doc_ids)}:{h}"


@dataclass(frozen=True)
class AndMask(Mask):
    """Intersection of component masks (``m1 & m2``)."""
    masks: Tuple[Mask, ...]

    def pattern(self, q_pos, k_pos):
        out = self.masks[0].pattern(q_pos, k_pos)
        for m in self.masks[1:]:
            out = out & m.pattern(q_pos, k_pos)
        return out

    def signature(self):
        return "and(" + ",".join(m.signature() for m in self.masks) + ")"


@dataclass(frozen=True)
class MultiHeadMask(Mask):
    """One mask per head. The kernels index their schedule row by the
    head (``Hs = H`` rows; a uniform mask has one row)."""
    masks: Tuple[Mask, ...]

    def __init__(self, masks):
        object.__setattr__(self, "masks", tuple(masks))
        if not self.masks:
            raise ValueError("MultiHeadMask needs at least one head mask")
        if any(isinstance(m, MultiHeadMask) for m in self.masks):
            raise TypeError("MultiHeadMask cannot nest")

    def pattern(self, q_pos, k_pos):
        raise TypeError("MultiHeadMask has no single pattern; use "
                        "head_masks() / dense()")

    def head_masks(self, heads: Optional[int] = None):
        if heads is not None and len(self.masks) != heads:
            raise ValueError(f"MultiHeadMask has {len(self.masks)} head "
                             f"masks; the operand has {heads} heads")
        return self.masks

    def dense(self, Tq, Tk):
        return np.stack([m.dense(Tq, Tk) for m in self.masks])

    def signature(self):
        return "mh(" + ",".join(m.signature() for m in self.masks) + ")"

    def __and__(self, other: Mask) -> "Mask":
        if isinstance(other, MultiHeadMask):
            if len(other.masks) != len(self.masks):
                raise ValueError(
                    f"cannot intersect MultiHeadMasks of {len(self.masks)}"
                    f" and {len(other.masks)} heads")
            return MultiHeadMask(tuple(a & b for a, b in
                                       zip(self.masks, other.masks)))
        return MultiHeadMask(tuple(m & other for m in self.masks))


def mask_from_spec(spec: str, T: int) -> Mask:
    """Parse the CLI/serve mask-spec mini-language into a Mask.

    ``causal`` | ``full`` | ``local:W[:R]`` (W-key causal window, or a
    band with R keys of right context) | ``prefix:N`` | ``doc[:L]``
    (documents of length L packed to T, full attention within; L
    defaults to T // 4). Specs compose with ``+`` as intersection:
    ``doc:2048+causal``, ``local:1024+prefix:128``."""
    if "+" in spec:
        parts = [mask_from_spec(s, T) for s in spec.split("+")]
        out = parts[0]
        for m in parts[1:]:
            out = out & m
        return out
    name, _, rest = spec.partition(":")
    args = [a for a in rest.split(":") if a] if rest else []
    if name == "causal":
        return CausalMask()
    if name == "full":
        return FullMask()
    if name == "local":
        if not args:
            raise ValueError("local mask needs a window: local:W[:R]")
        w = int(args[0])
        r = int(args[1]) if len(args) > 1 else 0
        return LocalMask(w, right=r)
    if name == "prefix":
        if not args:
            raise ValueError("prefix mask needs a length: prefix:N")
        return PrefixLMMask(int(args[0]))
    if name == "doc":
        doc_len = int(args[0]) if args else max(T // 4, 1)
        return DocumentMask(np.arange(T) // doc_len)
    raise ValueError(f"unknown mask spec {spec!r}; expected causal, full, "
                     "local:W[:R], prefix:N, or doc[:L]")


# ---------------------------------------------------------------------------
# compiled schedules


class BlockSchedule(NamedTuple):
    """One direction of a compiled mask: which minor-axis blocks each
    (head, resident tile) streams, in order.

    ``num`` [Hs, n_major]: active entries per tile (always >= 1; a
    fully-masked tile gets one all-zero PARTIAL entry so the kernel still
    writes its output rows).
    ``blk`` [Hs, n_major, L]: minor-axis block index per entry; padded
    trailing entries repeat the last active index.
    ``kind`` [Hs, n_major, L]: KIND_FULL / KIND_PARTIAL / 0 (padded).
    ``mid`` [Hs, n_major, L]: index into ``mask_blocks``; full entries
    carry the previous value forward.
    ``mask_blocks`` [M, bq, bk] int32 0/1: deduplicated partial-block
    bitmaps (row axis = query, column axis = key, in BOTH majors); id 0
    is always the all-ones bitmap."""
    num: np.ndarray
    blk: np.ndarray
    kind: np.ndarray
    mid: np.ndarray
    mask_blocks: np.ndarray


class MaskPrograms(NamedTuple):
    """The three schedules one ``flash_attention`` call consumes: ``fwd``
    (q-major at (bq, bk)), ``dq`` (q-major at the backward blocks),
    ``dkv`` (kv-major at the backward blocks)."""
    fwd: BlockSchedule
    dq: BlockSchedule
    dkv: BlockSchedule


@dataclass(frozen=True)
class ScheduleStats:
    """What a schedule executes, per head row."""
    executed_blocks: int          # entries the kernel runs (incl. forced)
    total_blocks: int             # dense grid: Hs * n_major * n_minor
    partial_blocks: int           # entries paying the bitmap compare
    full_blocks: int              # entries skipping it
    stream_len: int               # L, the longest schedule row

    @property
    def fraction(self) -> float:
        return self.executed_blocks / float(self.total_blocks)


def _compile_schedule(head_masks: Tuple[Mask, ...], Tq: int, Tk: int,
                      bq: int, bk: int, major: str
                      ) -> Tuple[BlockSchedule, ScheduleStats]:
    """Classify every (q block, k block) cell of every head mask and pack
    the executed ones into schedule arrays.

    ``major="q"``: resident q tiles stream kv blocks (fwd / dQ).
    ``major="kv"``: resident kv tiles stream q blocks (dKV). Cell bitmaps
    keep (query rows, key cols) orientation in both majors."""
    if Tq % bq or Tk % bk:
        raise ValueError(f"sequence ({Tq},{Tk}) must divide into blocks "
                         f"({bq},{bk})")
    n_q, n_k = Tq // bq, Tk // bk
    n_major, n_minor = (n_q, n_k) if major == "q" else (n_k, n_q)
    Hs = len(head_masks)
    ones = np.ones((bq, bk), bool)
    pool: Dict[bytes, int] = {ones.tobytes(): 0}
    bitmaps: List[np.ndarray] = [ones]

    def bitmap_id(cell: np.ndarray) -> int:
        key = cell.tobytes()
        if key not in pool:
            pool[key] = len(bitmaps)
            bitmaps.append(cell)
        return pool[key]

    entries: List[List[List[Tuple[int, int, int]]]] = []
    for m in head_masks:
        head_rows: List[List[Tuple[int, int, int]]] = []
        for t in range(n_major):
            if major == "q":
                slab = m.pattern(np.arange(t * bq, (t + 1) * bq),
                                 np.arange(Tk))        # [bq, Tk]
            else:
                slab = m.pattern(np.arange(Tq),
                                 np.arange(t * bk, (t + 1) * bk))  # [Tq,bk]
            row: List[Tuple[int, int, int]] = []
            cur_mid = 0
            for j in range(n_minor):
                cell = (slab[:, j * bk:(j + 1) * bk] if major == "q"
                        else slab[j * bq:(j + 1) * bq, :])
                if not cell.any():
                    continue                            # skipped: free
                if cell.all():
                    row.append((j, KIND_FULL, cur_mid))
                else:
                    cur_mid = bitmap_id(np.ascontiguousarray(cell))
                    row.append((j, KIND_PARTIAL, cur_mid))
            if not row:
                # fully-masked tile: one all-zero partial entry keeps the
                # epilogue writing something deterministic (finite
                # garbage: the all -1e30 scores give a uniform average of
                # the entry's v block, the SegmentIds empty-row caveat)
                row.append((0, KIND_PARTIAL,
                            bitmap_id(np.zeros((bq, bk), bool))))
            head_rows.append(row)
        entries.append(head_rows)

    L = max(len(r) for hr in entries for r in hr)
    num = np.zeros((Hs, n_major), np.int32)
    blk = np.zeros((Hs, n_major, L), np.int32)
    kind = np.zeros((Hs, n_major, L), np.int32)
    mid = np.zeros((Hs, n_major, L), np.int32)
    executed = partial = 0
    for h, head_rows in enumerate(entries):
        for t, row in enumerate(head_rows):
            num[h, t] = len(row)
            for s, (j, kd, mi) in enumerate(row):
                blk[h, t, s], kind[h, t, s], mid[h, t, s] = j, kd, mi
            last_j, _, last_mid = row[-1]
            for s in range(len(row), L):     # padded: revisit last block
                blk[h, t, s], mid[h, t, s] = last_j, last_mid
            executed += len(row)
            partial += sum(1 for _, kd, _ in row if kd == KIND_PARTIAL)
    sched = BlockSchedule(num=num, blk=blk, kind=kind, mid=mid,
                          mask_blocks=np.stack(bitmaps).astype(np.int32))
    stats = ScheduleStats(executed_blocks=executed,
                          total_blocks=Hs * n_major * n_minor,
                          partial_blocks=partial,
                          full_blocks=executed - partial,
                          stream_len=L)
    return sched, stats


@functools.lru_cache(maxsize=128)
def _compile_cached(mask: Mask, Tq: int, Tk: int, blocks,
                    heads: Optional[int]):
    hm = mask.head_masks(heads)
    fwd, fwd_stats = _compile_schedule(hm, Tq, Tk, blocks.bq, blocks.bk,
                                       "q")
    dq, bwd_stats = _compile_schedule(hm, Tq, Tk, blocks.bq_bwd,
                                      blocks.bk_bwd, "q")
    dkv, _ = _compile_schedule(hm, Tq, Tk, blocks.bq_bwd, blocks.bk_bwd,
                               "kv")
    return MaskPrograms(fwd=fwd, dq=dq, dkv=dkv), \
        {"fwd": fwd_stats, "bwd": bwd_stats}


def compile_mask_programs(mask: Mask, Tq: int, Tk: int, blocks,
                          heads: Optional[int] = None) -> MaskPrograms:
    """Mask -> the three kernel schedules at ``blocks``
    (:class:`~tosem_tpu_torch.ops.flash_blocks.BlockSizes`). Cached: one
    compile per (mask, shape, blocks, heads) per process, so the same
    key returns the same :class:`MaskPrograms` object. ``heads``
    validates :class:`MultiHeadMask` arity against the operand."""
    return _compile_cached(mask, Tq, Tk, blocks, heads)[0]


def program_stats(mask: Mask, Tq: int, Tk: int, blocks,
                  heads: Optional[int] = None) -> Dict[str, ScheduleStats]:
    """``{"fwd": stats, "bwd": stats}`` of the compiled schedules: what
    the kernel suite's FLOP model scales its T^2 terms by."""
    return _compile_cached(mask, Tq, Tk, blocks, heads)[1]


def executed_block_fraction(mask: Mask, Tq: int, Tk: int, blocks,
                            heads: Optional[int] = None, *,
                            which: str = "fwd") -> float:
    """Fraction of the dense block grid the schedule executes."""
    return program_stats(mask, Tq, Tk, blocks, heads)[which].fraction


def reset_program_cache() -> None:
    """Drop compiled schedules (tests)."""
    _compile_cached.cache_clear()


def pack_bitmaps(mask_blocks: np.ndarray) -> np.ndarray:
    """[M, bq, 64] 0/1 bitmaps -> [M, bq] int64 words, bit j of a row
    holding key j (the kernels' layout: one word per query row)."""
    if mask_blocks.shape[-1] != 64:
        raise ValueError(f"bitmaps pack 64 keys a word; these have "
                         f"{mask_blocks.shape[-1]}")
    bits = np.packbits(mask_blocks != 0, axis=-1, bitorder="little")
    return np.ascontiguousarray(bits).view("<i8")[..., 0]


def unpack_bitmaps(words: np.ndarray) -> np.ndarray:
    """The inverse of :func:`pack_bitmaps`: [M, bq] words -> [M, bq, 64]
    int32 0/1."""
    w = np.ascontiguousarray(np.asarray(words, "<i8"))[..., None]
    bits = np.unpackbits(w.view(np.uint8), axis=-1, bitorder="little")
    return bits.astype(np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch schedule lowering


def schedule_attention_torch(q, k, v, schedule: BlockSchedule, *,
                             sm_scale: Optional[float] = None,
                             layout: str = "bhtd", segment_ids=None):
    """Execute a q-major :class:`BlockSchedule` with plain PyTorch ops:
    gather exactly the scheduled K/V blocks, mask partial cells with
    their bitmaps and inactive entries entirely, softmax over the
    gathered axis (``l == 0`` read as 1). ``segment_ids``
    (``SegmentIds``-shaped, [B, Tq] / [B, Tk] int32) refine the gathered
    scores as in the kernels. Scores are fp32 products of the
    input-dtype operands; probabilities are cast to the value dtype
    before the PV product."""
    import torch

    if layout == "bthd":
        tr = lambda x: x.transpose(1, 2)
        return tr(schedule_attention_torch(tr(q), tr(k), tr(v), schedule,
                                           sm_scale=sm_scale,
                                           segment_ids=segment_ids))
    if layout != "bhtd":
        raise ValueError(f"unknown layout {layout!r}")
    dev = q.device
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    num, blk, kind, mid, mask_blocks = (
        torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)
        for a in schedule)
    Hs, n_major, L = blk.shape
    bq, bk = int(mask_blocks.shape[1]), int(mask_blocks.shape[2])
    if n_major != Tq // bq:
        raise ValueError("schedule is not q-major for this shape")
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    if Hs == 1:
        blk, kind, mid = (x.expand(H, n_major, L) for x in (blk, kind, mid))
        num = num.expand(H, n_major)
    kb = k.reshape(B, H, Tk // bk, bk, D)
    vb = v.reshape(B, H, Tk // bk, bk, D)
    heads = torch.arange(H, device=dev)[:, None, None]
    gk = kb[:, heads, blk]                    # [B, H, n_q, L, bk, D]
    gv = vb[:, heads, blk]
    qb = q.reshape(B, H, n_major, bq, D)
    s = torch.einsum("bhtqd,bhtlkd->bhtqlk", qb.float(), gk.float()) * scale
    bitmaps = mask_blocks[mid] != 0           # [H, n_q, L, bq, bk]
    keep = torch.where((kind == KIND_PARTIAL)[..., None, None], bitmaps,
                       (kind == KIND_FULL)[..., None, None])
    active = torch.arange(L, device=dev)[None, None, :] < num[..., None]
    keep = keep & active[..., None, None]
    # keep: [H, n_q, L, bq, bk] -> s's [B, H, n_q, bq, L, bk]
    s = torch.where(keep.permute(0, 1, 3, 2, 4)[None], s,
                    torch.full_like(s, _NEG_INF))
    if segment_ids is not None:
        qseg = segment_ids.q.to(device=dev, dtype=torch.int32) \
            .reshape(B, n_major, bq)
        kvb = segment_ids.kv.to(device=dev, dtype=torch.int32) \
            .reshape(B, Tk // bk, bk)
        gseg = kvb[:, blk]                    # [B, H, n_q, L, bk]
        segkeep = (qseg[:, None, :, :, None, None]
                   == gseg[:, :, :, None, :, :])
        s = torch.where(segkeep, s, torch.full_like(s, _NEG_INF))
    flat = s.reshape(B, H, n_major, bq, L * bk)
    m = flat.amax(-1, keepdim=True)
    p = torch.exp(flat - m)
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    p = p.reshape(B, H, n_major, bq, L, bk).to(v.dtype)
    out = torch.einsum("bhtqlk,bhtlkd->bhtqd", p.float(), gv.float())
    return out.reshape(B, H, Tq, D).to(q.dtype)


def schedule_lowering_torch(q, k, v, *, mask: Mask,
                            sm_scale: Optional[float] = None,
                            block_sizes=None, segment_ids=None,
                            layout: str = "bhtd"):
    """The ``torch`` arm of the ``schedule`` family in its mask-in call
    shape: compile the mask to a q-major program at ``block_sizes`` (the
    kernels' tiles when None) and run :func:`schedule_attention_torch`
    on it."""
    from tosem_tpu_torch.ops.flash_blocks import select_block_sizes

    if mask is None:
        raise ValueError("the schedule family lowers a Mask")
    if layout == "bhtd":
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
    elif layout == "bthd":
        B, Tq, H, D = q.shape
        Tk = k.shape[1]
    else:
        raise ValueError(f"unknown layout {layout!r}")
    blocks = block_sizes or select_block_sizes(
        Tq, D, str(q.dtype), Tk, mask_sig=mask.signature(), backend="torch")
    programs = compile_mask_programs(mask, Tq, Tk, blocks, heads=H)
    return schedule_attention_torch(q, k, v, programs.fwd,
                                    sm_scale=sm_scale, layout=layout,
                                    segment_ids=segment_ids)
