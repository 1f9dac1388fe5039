"""BERT-base fwd/bwd kernel suite on the card: north-star config 5.

Counterpart of ``tosem_tpu/ops/kernel_suite.py``, with the same rows,
``bench_id``\\ s, units, FLOP and byte models and ``extra`` keys, so the
two packages' rows mean the same. Shapes follow BERT-base: 12 heads of 64
(hidden 768), sequence 512. Attention is reported in GFLOPS (the FLOP
model is stated per row); layernorm and softmax are bound by device
memory and reported as effective GB/s (x read and y written; fp32
statistics stay inside the kernel).

Rows: flash attention forward and forward+backward, dense and causal (B1,
B2, B3); the dense path at the same shape (matmuls outside any kernel,
``extra["path"] = "dense"``; the JAX package's ``xla`` rows keep their
ids); ``fused_layernorm`` forward and forward+backward over
``[B*T, hidden]`` (B6, B7); ``fused_softmax`` forward and
forward+backward over ``[B*H*T, T]`` (B8, B9). Times are device time per
call from :class:`tosem_tpu_torch.utils.timing.DeviceLoopBench`.

:func:`sparse_kernel_suite` is the ``flash_sparse`` leg's: flash forward
and forward+backward under block-sparse mask programs (B1-B3's schedule
mode) at long context, GFLOPS counting only the tiles the schedules
execute.
"""
from __future__ import annotations

from typing import List

import torch

from tosem_tpu_torch.ops.common import resolve_device
from tosem_tpu_torch.ops.flash_attention import flash_attention
from tosem_tpu_torch.ops.flash_blocks import select_block_sizes
from tosem_tpu_torch.ops.fused_norms import fused_layernorm, fused_softmax
from tosem_tpu_torch.utils.results import ResultRow
from tosem_tpu_torch.utils.timing import DeviceLoopBench


def _row(bench_id, metric, value, unit, extra, device,
         config="bert_kernel_suite"):
    return ResultRow(project="ops", config=config, bench_id=bench_id,
                     metric=metric, value=value, unit=unit,
                     device="gpu" if device.type == "cuda" else "cpu",
                     n_devices=1, extra=extra)


def causal_block_fraction(T: int, bq: int, bk: int) -> float:
    """Fraction of (q-tile, k-tile) pairs a causal kernel executes: the
    pairs wholly above the diagonal are skipped. 1.0 at full-T tiles,
    toward 0.5 as tiles shrink; the port's 64 x 64 tiles give 0.5625 at
    T = 512."""
    bq, bk = min(bq, T), min(bk, T)
    n_q, n_k = T // bq, T // bk
    done = sum(min((i * bq + bq - 1) // bk + 1, n_k) for i in range(n_q))
    return done / float(n_q * n_k)


def attention_flops(B, H, T, D, *, bwd: bool,
                    causal_fraction: float = 1.0) -> float:
    """fwd: QK^T + PV = 4*B*H*T^2*D. bwd (flash, recompute): S recompute
    + dV + dP + dK + dQ = 10*B*H*T^2*D more. ``causal_fraction`` scales
    the total to the tile pairs the kernels execute."""
    fwd = 4.0 * B * H * T * T * D
    total = fwd + (10.0 * B * H * T * T * D if bwd else 0.0)
    return total * causal_fraction


def _grads(loss_of, *inputs):
    """The gradients of ``sum(f(*inputs).float() ** 2)`` w.r.t. every
    input: the JAX package's forward+backward op."""
    out = loss_of(*inputs)
    return torch.autograd.grad((out.float() ** 2).sum(), inputs)


def _leaf(x):
    return x.detach().requires_grad_()


def bert_kernel_suite(*, batch: int = 8, seq: int = 512, heads: int = 12,
                      head_dim: int = 64, hidden: int = 768,
                      dtype: str = "bfloat16", reps: int = 3,
                      n_iter: int = 0, device="cuda") -> List[ResultRow]:
    """The suite's rows at these shapes on ``device`` (the card unless the
    caller passes ``"cpu"``, where the plain versions run). ``n_iter``
    fixes the calls per timing (0 = enough for 20 ms on the card)."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype)
    gen = torch.Generator(dev).manual_seed(0)
    B, H, T, D = batch, heads, seq, head_dim

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    q, k, v = randn(B, H, T, D), randn(B, H, T, D), randn(B, H, T, D)
    rows: List[ResultRow] = []

    def sec_of(op, args):
        return DeviceLoopBench(op=op, args=args).time(reps=reps,
                                                      n_iter=n_iter)

    # the kernels' fixed tiles (ops/flash_blocks.py)
    blocks = select_block_sizes(T, D, dtype)
    blocks_src = select_block_sizes.last_source
    base = {"shape": [B, H, T, D], "dtype": dtype,
            "blocks": blocks.as_list(), "blocks_src": blocks_src}
    lq, lk, lv = _leaf(q), _leaf(k), _leaf(v)

    def flash(causal):
        return lambda a, b, c: flash_attention(a, b, c, None, causal)

    sec = sec_of(flash(False), (q, k, v))
    fl = attention_flops(B, H, T, D, bwd=False)
    rows.append(_row(f"attention_fwd_b{B}_t{T}_{dtype}", "gflops",
                     fl / sec / 1e9, "GFLOPS",
                     dict(base, flop_model="4BHT^2D", time_us=sec * 1e6),
                     dev))
    sec = sec_of(lambda a, b, c: _grads(flash(False), a, b, c), (lq, lk, lv))
    fl = attention_flops(B, H, T, D, bwd=True)
    rows.append(_row(f"attention_fwdbwd_b{B}_t{T}_{dtype}", "gflops",
                     fl / sec / 1e9, "GFLOPS",
                     dict(base, flop_model="14BHT^2D", time_us=sec * 1e6),
                     dev))

    # causal rows count only the tile pairs the kernels execute, at the
    # forward's and the backward's own tiles
    frac_fwd = causal_block_fraction(T, blocks.bq, blocks.bk)
    frac_bwd = causal_block_fraction(T, blocks.bq_bwd, blocks.bk_bwd)
    sec = sec_of(flash(True), (q, k, v))
    fl = attention_flops(B, H, T, D, bwd=False, causal_fraction=frac_fwd)
    rows.append(_row(f"attention_fwd_causal_b{B}_t{T}_{dtype}", "gflops",
                     fl / sec / 1e9, "GFLOPS",
                     dict(base, flop_model=f"4BHT^2D x {frac_fwd:.4g} "
                                           "(causal: executed block pairs "
                                           "only)",
                          causal=True, causal_fraction=frac_fwd,
                          time_us=sec * 1e6), dev))
    sec = sec_of(lambda a, b, c: _grads(flash(True), a, b, c), (lq, lk, lv))
    fl = (attention_flops(B, H, T, D, bwd=False, causal_fraction=frac_fwd)
          + (attention_flops(B, H, T, D, bwd=True, causal_fraction=frac_bwd)
             - attention_flops(B, H, T, D, bwd=False,
                               causal_fraction=frac_bwd)))
    rows.append(_row(f"attention_fwdbwd_causal_b{B}_t{T}_{dtype}",
                     "gflops", fl / sec / 1e9, "GFLOPS",
                     dict(base, flop_model=f"(4 x {frac_fwd:.4g} + 10 x "
                                           f"{frac_bwd:.4g})BHT^2D (causal: "
                                           "executed block pairs only)",
                          causal=True, causal_fraction=frac_bwd,
                          time_us=sec * 1e6), dev))

    # the dense path at the same shape: it materialises the [B,H,T,T]
    # scores, so past ~1 GB of them (long contexts) it is left out
    scores_bytes = B * H * T * T * q.element_size()
    if scores_bytes <= 1 << 30:
        from tosem_tpu_torch.nn.attention import dot_product_attention

        def dense(a, b, c):
            tr = lambda x: x.transpose(1, 2)      # [B,H,T,D] <-> [B,T,H,D]
            return tr(dot_product_attention(tr(a), tr(b), tr(c)))

        dense_extra = {"shape": [B, H, T, D], "dtype": dtype,
                       "path": "dense"}
        sec = sec_of(dense, (q, k, v))
        fl = attention_flops(B, H, T, D, bwd=False)
        rows.append(_row(f"attention_fwd_xla_b{B}_t{T}_{dtype}", "gflops",
                         fl / sec / 1e9, "GFLOPS",
                         dict(dense_extra, flop_model="4BHT^2D",
                              time_us=sec * 1e6), dev))
        sec = sec_of(lambda a, b, c: _grads(dense, a, b, c), (lq, lk, lv))
        # the dense path keeps its activations (no recompute): its work
        # is 4 fwd + 8 bwd = 12BHT^2D; compare paths by time_us
        fl = 12.0 * B * H * T * T * D
        rows.append(_row(f"attention_fwdbwd_xla_b{B}_t{T}_{dtype}",
                         "gflops", fl / sec / 1e9, "GFLOPS",
                         dict(dense_extra, flop_model="12BHT^2D (no "
                                                      "recompute)",
                              time_us=sec * 1e6), dev))
    del q, k, v, lq, lk, lv

    # layernorm forward / forward+backward over [B*T, hidden]
    x = randn(B * T, hidden)
    g = torch.ones(hidden, dtype=dt, device=dev)
    bt = torch.zeros(hidden, dtype=dt, device=dev)
    nbytes = x.numel() * x.element_size()
    sec = sec_of(fused_layernorm, (x, g, bt))
    rows.append(_row(f"layernorm_fwd_{B * T}x{hidden}_{dtype}", "gbps",
                     2 * nbytes / sec / 1e9, "GB/s",
                     {"bytes": 2 * nbytes, "time_us": sec * 1e6,
                      "dtype": dtype}, dev))
    sec = sec_of(lambda a, b, c: _grads(fused_layernorm, a, b, c),
                 (_leaf(x), _leaf(g), _leaf(bt)))
    rows.append(_row(f"layernorm_fwdbwd_{B * T}x{hidden}_{dtype}", "gbps",
                     4 * nbytes / sec / 1e9, "GB/s",
                     {"bytes": 4 * nbytes, "time_us": sec * 1e6,
                      "dtype": dtype}, dev))
    del x, g, bt

    # softmax forward / forward+backward over the attention logits'
    # [B*H*T, T], rows capped so the buffer stays <= 256 MB at long T
    itemsize = torch.empty((), dtype=dt).element_size()
    sm_rows = min(B * H * T, max(256, (256 << 20) // (T * itemsize)))
    s = randn(sm_rows, T)
    nbytes = s.numel() * s.element_size()
    sec = sec_of(fused_softmax, (s,))
    rows.append(_row(f"softmax_fwd_{sm_rows}x{T}_{dtype}", "gbps",
                     2 * nbytes / sec / 1e9, "GB/s",
                     {"bytes": 2 * nbytes, "time_us": sec * 1e6,
                      "dtype": dtype}, dev))
    sec = sec_of(lambda a: _grads(fused_softmax, a), (_leaf(s),))
    rows.append(_row(f"softmax_fwdbwd_{sm_rows}x{T}_{dtype}", "gbps",
                     4 * nbytes / sec / 1e9, "GB/s",
                     {"bytes": 4 * nbytes, "time_us": sec * 1e6,
                      "dtype": dtype}, dev))
    return rows


def sparse_kernel_suite(*, batch: int = 1, seq: int = 8192,
                        heads: int = 12, head_dim: int = 64,
                        dtype: str = "bfloat16", window: int = 1024,
                        doc_len: int = 0, reps: int = 3, n_iter: int = 0,
                        device="cuda") -> List[ResultRow]:
    """Block-sparse mask-program rows: one forward and one
    forward+backward row per scenario, all at the same shape: causal
    (``CausalMask`` as a program, the comparison anchor), the causal
    sliding window ``LocalMask(window)``, and packed documents of
    ``doc_len`` (default ``seq // 4``) intersected with causal. The FLOP
    model counts only the tiles each schedule executes
    (``extra["executed_block_fraction"]``, from :func:`program_stats` at
    the kernels' 64 x 64 tiles), so a sparse row cannot claim skipped
    work. Ids, units and ``extra`` keys are the JAX package's."""
    from tosem_tpu_torch.ops.mask_programs import (mask_from_spec,
                                                   program_stats)
    dev = resolve_device(device)
    dt = getattr(torch, dtype)
    gen = torch.Generator(dev).manual_seed(0)
    B, H, T, D = batch, heads, seq, head_dim

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    q, k, v = randn(B, H, T, D), randn(B, H, T, D), randn(B, H, T, D)
    lq, lk, lv = _leaf(q), _leaf(k), _leaf(v)
    doc_len = doc_len or max(seq // 4, 1)
    scenarios = [("causal", "causal"),
                 (f"local{window}", f"local:{window}"),
                 (f"docpack{doc_len}", f"doc:{doc_len}+causal")]
    rows: List[ResultRow] = []
    for name, spec in scenarios:
        mask = mask_from_spec(spec, T)
        sig = mask.signature()
        blocks = select_block_sizes(T, D, dtype, mask_sig=sig)
        blocks_src = select_block_sizes.last_source
        stats = program_stats(mask, T, T, blocks, heads=H)
        frac_fwd, frac_bwd = stats["fwd"].fraction, stats["bwd"].fraction
        extra_base = {"shape": [B, H, T, D], "dtype": dtype, "mask": sig,
                      "blocks": blocks.as_list(), "blocks_src": blocks_src}

        def fwd(a, b, c, m=mask):
            return flash_attention(a, b, c, mask=m)
        sec = DeviceLoopBench(op=fwd, args=(q, k, v)).time(reps=reps,
                                                          n_iter=n_iter)
        fl = attention_flops(B, H, T, D, bwd=False, causal_fraction=frac_fwd)
        rows.append(_row(f"attention_fwd_{name}_b{B}_t{T}_{dtype}", "gflops",
                         fl / sec / 1e9, "GFLOPS",
                         dict(extra_base,
                              flop_model=f"4BHT^2D x {frac_fwd:.4g} "
                                         "(executed blocks only)",
                              executed_block_fraction=frac_fwd,
                              time_us=sec * 1e6),
                         dev, config="flash_sparse"))
        sec = DeviceLoopBench(
            op=lambda a, b, c, f=fwd: _grads(f, a, b, c),
            args=(lq, lk, lv)).time(reps=reps, n_iter=n_iter)
        fl = (attention_flops(B, H, T, D, bwd=False,
                              causal_fraction=frac_fwd)
              + (attention_flops(B, H, T, D, bwd=True,
                                 causal_fraction=frac_bwd)
                 - attention_flops(B, H, T, D, bwd=False,
                                   causal_fraction=frac_bwd)))
        rows.append(_row(f"attention_fwdbwd_{name}_b{B}_t{T}_{dtype}",
                         "gflops", fl / sec / 1e9, "GFLOPS",
                         dict(extra_base,
                              flop_model=f"(4 x {frac_fwd:.4g} + 10 x "
                                         f"{frac_bwd:.4g})BHT^2D "
                                         "(executed blocks only)",
                              executed_block_fraction=frac_bwd,
                              time_us=sec * 1e6),
                         dev, config="flash_sparse"))
    return rows
