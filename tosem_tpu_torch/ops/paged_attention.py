"""Paged-KV decode attention: the CUDA kernels and their plain versions.

Counterpart of ``tosem_tpu/ops/paged_attention.py``, with its layout
contracts:

- ``q``: [B, H, D] (one decode token per sequence) or [B, k, H, D]
  (k query rows per sequence, any k);
- ``k_pages``/``v_pages``: [P, page_size, H, D] pools;
- ``block_tables``: [B, max_pages] int32 physical page ids;
- ``seq_lens``: [B] int32 cached tokens per sequence (0 = inactive row,
  whose output is exact zeros).

On CUDA tensors a one-token call with no options launches
``paged_decode`` (the port of the Pallas ``_decode_kernel``) and every
other call ``paged_decode_multi`` (the port of ``_decode_multi_kernel``),
both in ``csrc/paged_decode.cu``: one block per (sequence, head, chunk of
the key axis), then a second kernel that combines each row's chunks in
chunk-index order. The chunks are fixed by the table width and the page
size alone (:func:`_decode_chunks`), so a call never reads ``seq_lens``
on the host. On CPU tensors the plain versions run:
a gather of the block-table pages and a masked softmax, mirroring the
JAX package's ``_paged_attention_xla`` / ``_paged_attention_xla_multi``.

Multi-token row r holds the token at position ``seq_len - q_rows + r``
and attends causally up to itself; rows past ``q_rows`` mirror the last
real one. ``window`` keeps each row's ``window`` most recent keys;
``page_offsets`` says block-table slot j holds logical page
``page_offsets[b] + j``. Both arms compute a multi-token row with exactly
the arithmetic of the one-token call at that row's length, so row r is
bit-identical to a sequential step on each arm.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tosem_tpu_torch.ops import _build, registry

_NEG_INF = -1e30
_KERNEL_D = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# B4/B5 split the key axis into chunks of whole pages holding about this
# many keys (one page when a page is larger)
_CHUNK_KEYS = 128


def _decode_chunks(W: int, page: int):
    """The key-axis plan of B4/B5 for a block table ``W`` slots wide:
    ``(pages_per_chunk, n_chunks)``. Chunk c holds table slots
    ``[c * pages_per_chunk, (c + 1) * pages_per_chunk)`` (the last one
    clipped at W), so the chunks cover all ``W * page`` key positions at
    fixed boundaries, whatever the sequences' lengths."""
    if W < 1 or page < 1:
        raise ValueError(f"chunk plan needs W, page >= 1; got {(W, page)}")
    ppc = max(1, _CHUNK_KEYS // page)
    return ppc, -(-W // ppc)


# ---------------------------------------------------------------- plain arm


def _gather(pages, block_tables):
    """[P, page, H, D] pool, [B, W] table -> [B, W * page, H, D]."""
    B, W = block_tables.shape
    g = pages[block_tables.long()]
    return g.reshape(B, W * pages.shape[1], pages.shape[2], pages.shape[3])


def _attend_rows(q, k, v, pos, bound, window, sm_scale):
    """One query row per sequence: q [B, H, D] over gathered k/v
    [B, T, H, D]; key t of sequence b sits at position ``pos[b, t]`` and
    is visible when ``pos <= bound[b]`` (and inside the window). The dot
    products are products summed over the last dim, not a batched
    matmul (whose CPU kernel changes with the batch count), each
    reduced over the contiguous last dim of a fresh product, so a
    (sequence, head) cell gets the same bits however many share the
    call, as on the card: a sharded call equals the unsharded one."""
    s = (q.float()[:, :, None] * k.float().permute(0, 2, 1, 3)).sum(-1) \
        * sm_scale
    valid = pos <= bound[:, None]
    if window is not None:
        valid = valid & (pos > bound[:, None] - window)
    valid = valid[:, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    p = (p / l).to(v.dtype)
    out = (p.float()[:, :, None] * v.float().permute(0, 2, 3, 1)).sum(-1)
    return out.to(q.dtype)


def _positions(block_tables, page_size, page_offsets):
    B, W = block_tables.shape
    t = torch.arange(W * page_size, dtype=torch.int32,
                     device=block_tables.device)[None, :]
    if page_offsets is None:
        return t.expand(B, -1)
    return page_offsets.to(torch.int32)[:, None] * page_size + t


def _paged_attention_torch(q, k_pages, v_pages, block_tables, seq_lens,
                           sm_scale):
    """Plain version of the one-token call (``_paged_attention_xla``)."""
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    pos = _positions(block_tables, k_pages.shape[1], None)
    bound = seq_lens.to(torch.int32) - 1
    return _attend_rows(q, k, v, pos, bound, None, sm_scale)


def _paged_attention_torch_multi(q, k_pages, v_pages, block_tables,
                                 seq_lens, q_rows, page_offsets, sm_scale,
                                 window):
    """Plain version of the general call (``_paged_attention_xla_multi``):
    each row is :func:`_attend_rows` at that row's causal bound, the
    same computation a one-token call at that length makes."""
    K = q.shape[1]
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    pos = _positions(block_tables, k_pages.shape[1], page_offsets)
    sl = seq_lens.to(torch.int32)
    kr = q_rows.to(torch.int32)
    rows = []
    for r in range(K):
        bound = sl - kr + torch.clamp(kr - 1, max=r)
        rows.append(_attend_rows(q[:, r].contiguous(), k, v, pos, bound,
                                 window, sm_scale))
    return torch.stack(rows, dim=1)


def _paged_plain(q, k_pages, v_pages, block_tables, seq_lens, sm_scale,
                 q_rows, window, page_offsets):
    """The plain version of any call: the one-token form for a one-token
    call with no options, the general form otherwise."""
    if (q.ndim == 3 and q_rows is None and window is None
            and page_offsets is None):
        return _paged_attention_torch(q, k_pages, v_pages, block_tables,
                                      seq_lens, sm_scale)
    multi = q.ndim == 4
    q4 = q if multi else q[:, None]
    B, K = q4.shape[:2]
    kr = (torch.full((B,), K, dtype=torch.int32, device=q.device)
          if q_rows is None else q_rows)
    out = _paged_attention_torch_multi(q4, k_pages, v_pages, block_tables,
                                       seq_lens, kr, page_offsets, sm_scale,
                                       window)
    return out if multi else out[:, 0]


# ----------------------------------------------------------------- CUDA arm

_SINGLE_ARGS = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
                + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
_MULTI_ARGS = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
               + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])


def _kernel(name, argtypes):
    fn = getattr(_build.load("paged_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(q, k_pages, v_pages, ints):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged kernels take float32/bfloat16, got {q.dtype}")
    D = q.shape[-1]
    if D not in _KERNEL_D:
        raise ValueError(f"paged kernels take head dim in {_KERNEL_D}, "
                         f"got {D}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} dtype {x.dtype} != q dtype {q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # the kernels read q, K and V as 16-byte vectors
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name, x, shape in ints:
        if x is None:
            continue
        if (x.dtype != torch.int32 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(
                f"{name} must be contiguous int32 {shape} on {q.device}; "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _chunk_scratch(q, B, K, H, D, W, page):
    """The chunk plan and the fp32 scratch of its partials: per (sequence,
    head, chunk, row) the PV sum (D floats), then (m, l) per row; sized
    from shapes alone."""
    ppc, n_chunks = _decode_chunks(W, page)
    part = torch.empty(B * H * n_chunks * K * (D + 2), dtype=torch.float32,
                       device=q.device)
    return ppc, n_chunks, part


def _paged_decode_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                       sm_scale):
    """Launch B4 (``paged_decode``) for q [B, H, D]."""
    B, H, D = q.shape
    W = block_tables.shape[1]
    _check_cuda_operands(q, k_pages, v_pages,
                         (("block_tables", block_tables, (B, W)),
                          ("seq_lens", seq_lens, (B,))))
    page = k_pages.shape[1]
    ppc, n_chunks, part = _chunk_scratch(q, B, 1, H, D, W, page)
    out = torch.empty_like(q)
    code = _kernel("paged_decode", _SINGLE_ARGS)(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), out.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), part.data_ptr(), B, H, W, page, ppc, n_chunks,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_decode")
    registry.count_launch("paged_decode")
    return out


def _paged_decode_multi_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                             q_rows, page_offsets, sm_scale, window):
    """Launch B5 (``paged_decode_multi``) for q [B, K, H, D]."""
    B, K, H, D = q.shape
    W = block_tables.shape[1]
    _check_cuda_operands(q, k_pages, v_pages,
                         (("block_tables", block_tables, (B, W)),
                          ("seq_lens", seq_lens, (B,)),
                          ("q_rows", q_rows, (B,)),
                          ("page_offsets", page_offsets, (B,))))
    page = k_pages.shape[1]
    ppc, n_chunks, part = _chunk_scratch(q, B, K, H, D, W, page)
    out = torch.empty_like(q)
    code = _kernel("paged_decode_multi", _MULTI_ARGS)(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), out.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(),
        None if q_rows is None else q_rows.data_ptr(),
        None if page_offsets is None else page_offsets.data_ptr(),
        part.data_ptr(), B, K, H, W, page, ppc, n_chunks,
        0 if window is None else int(window), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_decode_multi")
    registry.count_launch("paged_decode_multi")
    return out


# -------------------------------------------------------------- public op


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    sm_scale: Optional[float] = None,
                    backend: Optional[str] = None,
                    q_rows=None, window: Optional[int] = None,
                    page_offsets=None):
    """Decode attention over a paged KV cache (see the module docstring
    for the operand contracts). ``backend`` is ``"cuda"`` or ``"torch"``
    (None = the operands' platform)."""
    multi = q.ndim == 4
    if multi:
        B, K, H, D = q.shape
        if K < 1:
            raise ValueError(f"q tokens {K} must be >= 1")
    elif q.ndim == 3:
        B, H, D = q.shape
        K = 1
    else:
        raise ValueError(f"q must be [B, H, D] or [B, k, H, D], got "
                         f"{tuple(q.shape)}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    if k_pages.shape[2] != H or k_pages.shape[3] != D:
        raise ValueError(f"pool heads/dim {tuple(k_pages.shape[2:])} do not "
                         f"match q {(H, D)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be [B={B}, max_pages], got "
                         f"{tuple(block_tables.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    served = registry.resolve("paged", backend,
                              platform=registry.platform_of(q),
                              dtype=registry.dtype_name(q.dtype))
    if served == registry.BACKEND_TORCH:
        return _paged_plain(q, k_pages, v_pages, block_tables, seq_lens,
                            scale, q_rows, window, page_offsets)
    general = multi or window is not None or page_offsets is not None \
        or q_rows is not None
    if not general:
        return _paged_decode_cuda(q, k_pages, v_pages, block_tables,
                                  seq_lens, scale)
    q4 = q if multi else q[:, None]
    out = _paged_decode_multi_cuda(q4.contiguous(), k_pages, v_pages,
                                   block_tables, seq_lens, q_rows,
                                   page_offsets, scale, window)
    return out if multi else out[:, 0]


def paged_partition_specs(data_axis="dp", model_axis="tp", multi=False):
    """The partition specs that shard this kernel over a mesh
    (:func:`tosem_tpu_torch.parallel.flash.sharded_paged_attention`): the
    KV pools shard their HEAD dim over the model axis (each position owns
    its heads' slice of every page, so a block-table id resolves locally),
    q shards batch over data and heads over model, and the per-sequence
    operands (block tables, seq lens, ``q_rows``, ``page_offsets``) follow
    the batch. A dict keyed by operand name; ``multi`` selects the [B, K,
    H, D] query layout."""
    from tosem_tpu_torch.parallel.spmd import P
    q_spec = (P(data_axis, None, model_axis, None) if multi
              else P(data_axis, model_axis, None))
    return {
        "q": q_spec,
        "kv_pages": P(None, None, model_axis, None),
        "block_tables": P(data_axis, None),
        "seq_lens": P(data_axis),
        "q_rows": P(data_axis),
        "page_offsets": P(data_axis),
        "out": q_spec,
    }


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              *, sm_scale=None, q_rows=None, window=None,
                              page_offsets=None):
    """Dense reference: the plain versions, on whatever device the
    operands live (``chip_smoke.py`` holds the kernels against it)."""
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    return _paged_plain(q, k_pages, v_pages, block_tables, seq_lens, scale,
                        q_rows, window, page_offsets)
