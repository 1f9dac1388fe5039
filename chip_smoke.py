#!/usr/bin/env python3
"""Drive the PyTorch port (``tosem_tpu_torch``) end to end on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it exits non-zero and prints no
result when either is missing or when the package is not beside it.

Phases, each printing one JSON line:

1. build    — nvcc builds every kernel source of ``tosem_tpu_torch/ops/csrc``
              (one process per source, started together).
2. kernels  — each CUDA kernel against its plain PyTorch version on the
              card, at the main path's shapes, bf16 and fp32, with its
              time (CUDA events), its bound from bytes and operations,
              and a library yardstick where one PyTorch call computes
              the same function. The backward kernels (B2 dK/dV, B3 dQ)
              also in both layouts, at a ragged length, and launched
              twice to show they are bit-deterministic.
3. decode   — BERT-base greedy decode through ``BertDecodeBackend``'s
              client protocol: 8 packed prompts x 32 new tokens, then a
              prompt that hits the prefix cache, whose stream must equal
              its cold stream with the prefix cache off.
4. encode   — one padded BERT-base batch through ``BertEncodeBackend``.
5. cpu      — three short prompts through the port on the card and on
              the CPU with the same weights; first-step logits must agree.
              Two yardsticks beside them: the card's bf16 logits against
              the CPU's fp32 ones, and a deliberately wrong CPU model.
6. profile  — decode steps, a prefill and an encode batch, each timed
              on the host clock without the profiler and then traced
              under torch.profiler: the device time the trace sees over
              the unprofiled wall time is the device's busy share.
7. train    — the BERT-base masked-LM train step of the JAX package's
              ``bert_train`` leg (8 x 512, bf16, dropout 0.1, adamw(1e-4))
              through ``make_train_step``: 10 timed steps with flash
              attention (B1 forward, B2 and B3 backward) whose loss must
              fall, the same steps with dense attention, a padded batch
              (the kernels' segment mode), fp32 gradients checked flash
              against dense and card against CPU (with a wrong-model
              yardstick), remat full/dots against none bit for bit,
              ``fit`` resumed after a preemption bit for bit, and a
              profile of the step.

``--phases`` picks a subset (default: all seven), e.g. ``build,kernels``
for a first call after a kernel change, or ``build,kernels,train`` for
the training path.

The launch counts of every kernel are set to 0 just before the decode,
the encode and the train paths run and read just after; a kernel of the
path that never launched fails the run. Before the last line it prints the card's name and
power limit (``nvidia-smi``) and one ``{"kernels": [...]}`` line; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense), at its 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"flash": {"float32": 2e-5, "bfloat16": 2e-2},
       "paged": {"float32": 5e-6, "bfloat16": 2e-2}}
# backward: (atol, rtol) of tests/test_pallas_kernels.py; bf16 gradients
# are held against the fp32 plain version of the same inputs
BWD_TOL = {"float32": (5e-4, 5e-3), "bfloat16": (0.5, 5e-2)}
# bf16 gradients are also held, each tensor as a whole, to
# max|g - w| <= BWD_REL * max|w|, against the bf16 plain backward on the
# same LSE and Delta and against the fp32 plain version: two bf16 ulps at
# the largest element. A sound kernel stays near 0.003 (same) and 0.005
# (fp32); a dK scaled by 1.05 or a dropped mask, the yardsticks checked
# beside it, reach 0.05 and above.
BWD_REL = 1.0 / 64
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "paged_decode",
           "paged_decode_multi")

SEED = 0            # weights, prompts and kernel inputs
NEW_TOKENS = 32     # generated per decode prompt


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(text):
    """``{kernel: "registers; spills"}`` from nvcc's ``-Xptxas -v``
    output, each entry function named by its mangled name."""
    out, name = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.split(":")[-1]
                         .strip()).strip()
    return out


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- kernels


def flash_case(dev, dtype, B, T, mode, gen):
    """One B1 case in the main path's [B, T, H, D] layout."""
    import torch
    from tosem_tpu_torch.ops.flash_attention import SegmentIds
    H, D = 12, 64
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, T, H, D, generator=gen).to(tdt).to(dev)
               for _ in range(3))
    seg = None
    if mode == "segments":
        lengths = [max(1, T - 37 * (b + 1)) for b in range(B)]
        kv = torch.zeros(B, T, dtype=torch.int32)
        for b, n in enumerate(lengths):
            kv[b, :n] = 1
        seg = SegmentIds(torch.ones(B, T, dtype=torch.int32, device=dev),
                         kv.to(dev))
    return q, k, v, seg


def flash_work(q, seg, causal):
    """(bytes, operations) the forward needs on these inputs: q/k/v and
    segment ids read once, O and LSE written once; 4*D operations per
    visible (query, key) pair."""
    B, T, H, D = q.shape
    el = q.element_size()
    nbytes = 4 * B * T * H * D * el + B * H * T * 4
    if seg is not None:
        nbytes += 2 * B * T * 4
        pairs = T * int((seg.kv != 0).sum().item())
    elif causal:
        pairs = B * T * (T + 1) // 2
    else:
        pairs = B * T * T
    return nbytes, 4 * D * H * pairs


def run_flash(q, k, v, seg, causal):
    from tosem_tpu_torch.ops.flash_attention import _flash_fwd_cuda
    return _flash_fwd_cuda(q, k, v, seg, causal, 1.0 / 8.0, "bthd")


def plain_flash(q, k, v, seg, causal):
    from tosem_tpu_torch.ops.flash_attention import _flash_attention_torch
    return _flash_attention_torch(q, k, v, seg, causal, 1.0 / 8.0, "bthd")


def sdpa(q, k, v, seg, causal):
    """Library yardstick, timed here only (the port never calls it)."""
    import torch.nn.functional as F
    mask = None
    if seg is not None:
        mask = (seg.q[:, :, None] == seg.kv[:, None, :])[:, None]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and mask is None, scale=1.0 / 8.0)


def bwd_work(q, seg, which):
    """(bytes, operations) of B2 (``which="dkv"``) or B3 (``"dq"``) on
    these inputs: q, k, v, dO, LSE, Delta and segment ids read once, the
    gradients written once; 8*D (dK/dV) or 6*D (dQ) operations per
    visible (query, key) pair."""
    B, T, H, D = q.shape
    el = q.element_size()
    grads = 2 if which == "dkv" else 1
    nbytes = (4 + grads) * B * T * H * D * el + 2 * B * H * T * 4
    if seg is not None:
        nbytes += 2 * B * T * 4
        pairs = T * int((seg.kv != 0).sum().item())
    else:
        pairs = B * T * T
    return nbytes, (8 if which == "dkv" else 6) * D * H * pairs


def run_bwd(q, k, v, do, seg, causal, layout):
    """B1 forward, Delta, then B2 and B3. Returns ``((dq, dk, dv), lse,
    delta)``."""
    from tosem_tpu_torch.ops import flash_attention as fa
    out, lse = fa._flash_fwd_cuda(q, k, v, seg, causal, 1.0 / 8.0, layout)
    delta = fa._bwd_delta(do, out, layout)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, seg, causal,
                                    1.0 / 8.0, layout)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, seg, causal,
                               1.0 / 8.0, layout)
    return (dq, dk, dv), lse, delta


def plain_bwd(q, k, v, do, lse, delta, seg, causal, layout):
    from tosem_tpu_torch.ops import flash_attention as fa
    dk, dv = fa._flash_bwd_dkv_torch(q, k, v, do, lse, delta, seg, causal,
                                     1.0 / 8.0, layout)
    dq = fa._flash_bwd_dq_torch(q, k, v, do, lse, delta, seg, causal,
                                1.0 / 8.0, layout)
    return dq, dk, dv


def plain_bwd_fp32(q, k, v, do, seg, causal, layout):
    """The plain forward and backward on the fp32 copies of the inputs."""
    from tosem_tpu_torch.ops import flash_attention as fa
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out, lse = fa._flash_attention_torch(qf, kf, vf, seg, causal, 1.0 / 8.0,
                                         layout)
    delta = fa._bwd_delta(dof, out, layout)
    return plain_bwd(qf, kf, vf, dof, lse, delta, seg, causal, layout)


def sdpa_fwd_bwd(q, k, v, do, seg):
    """Library yardstick for the whole attention step, timed here only:
    SDPA forward and its autograd backward (no single call computes dK/dV
    or dQ alone)."""
    import torch
    import torch.nn.functional as F
    mask = None
    if seg is not None:
        mask = (seg.q[:, :, None] == seg.kv[:, None, :])[:, None]
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         scale=1.0 / 8.0)
    return torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2))


def bwd_cases(dev, gen, lines):
    """B2 and B3 against their plain versions in every mode, layout and
    dtype, at a ragged length and at the training shape; bit-determinism
    across two launches; times at [8, 512, 12, 64] bf16 dense and
    segments (layout bthd, the model's)."""
    import torch
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.ops import flash_attention as fa
    cases = []
    for dtype in ("bfloat16", "float32"):
        for B, T in ((2, 300), (8, 512)):
            for mode in ("dense", "causal", "segments"):
                for layout in ("bthd", "bhtd"):
                    q, k, v, seg = flash_case(dev, dtype, B, T, mode, gen)
                    do = torch.randn(q.shape, generator=gen).to(q.dtype)
                    do = do.to(dev)
                    if layout == "bhtd":
                        q, k, v, do = (x.transpose(1, 2)
                                       for x in (q, k, v, do))
                        do = do.contiguous()
                    causal = mode == "causal"
                    got, lse, delta = run_bwd(q, k, v, do, seg, causal,
                                              layout)
                    again, _, _ = run_bwd(q, k, v, do, seg, causal, layout)
                    with precision("float32"):
                        ref32 = plain_bwd_fp32(q, k, v, do, seg, causal,
                                               layout)
                        same = plain_bwd(q, k, v, do, lse, delta, seg,
                                         causal, layout)
                    torch.cuda.synchronize()
                    atol, rtol = BWD_TOL[dtype]
                    want = ref32 if dtype == "bfloat16" else same
                    errs, ok = {}, True
                    for name, g, w, s in zip(("dq", "dk", "dv"), got, want,
                                             same):
                        diff = (g.float() - w.float()).abs()
                        errs[name] = diff.max().item()
                        errs[name + "_vs_same_dtype"] = (
                            g.float() - s.float()).abs().max().item()
                        ok &= bool((diff <= atol + rtol * w.float().abs())
                                   .all().item())
                    check(ok, f"flash bwd {mode} {dtype} {layout} [{B},{T}] "
                              f"outside atol {atol} / rtol {rtol}: {errs}")
                    rel = None
                    if dtype == "bfloat16":
                        rel = bwd_rel_check(q, k, v, do, lse, delta, seg,
                                            causal, layout, got, same, ref32)
                    bits = all(torch.equal(a, b) for a, b in zip(got, again))
                    check(bits, f"flash bwd {mode} {dtype} {layout} "
                                "differs between two launches")
                    rec = {"kernel": "flash_bwd", "mode": mode,
                           "dtype": dtype, "layout": layout,
                           "shape": [B, T, 12, 64], "max_abs_err": errs,
                           "against": ("plain fp32" if dtype == "bfloat16"
                                       else "plain, same inputs"),
                           "bit_deterministic": bits}
                    if rel is not None:
                        rec["rel_err"] = rel
                    if (dtype, B, layout) == ("bfloat16", 8, "bthd") \
                            and mode != "causal":
                        rec.update(time_bwd(q, k, v, do, lse, delta, seg,
                                            errs, lines, mode))
                    cases.append(rec)
                    del got, again, ref32, same
    return cases


def rel_err(g, w):
    """max|g - w| / max|w| over one gradient tensor."""
    return ((g.float() - w.float()).abs().max()
            / w.float().abs().max()).item()


def bwd_rel_check(q, k, v, do, lse, delta, seg, causal, layout, got, same,
                  ref32):
    """Hold bf16 B2/B3 gradients to ``BWD_REL`` of their largest element
    against ``same`` (the bf16 plain backward on the kernel's LSE and
    Delta) and ``ref32``, and show that the check catches wrong
    gradients: ``same`` with dK scaled by 1.05, and, where the case has a
    mask, the plain backward with the mask dropped."""
    names = ("dq", "dk", "dv")
    out = {"limit": BWD_REL}
    for against, want in (("same", same), ("fp32", ref32)):
        r = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
        out[against] = r
        check(max(r.values()) <= BWD_REL,
              f"flash bwd bf16 {layout}: max|g - w| / max|w| against "
              f"{against} above {BWD_REL}: {r}")
    wrong = {"dk_x1.05": (same[0], same[1].float() * 1.05, same[2])}
    if causal or seg is not None:
        wrong["mask_dropped"] = plain_bwd(q, k, v, do, lse, delta, None,
                                          False, layout)
    out["yardsticks"] = {}
    for what, bad in wrong.items():
        worst = max(rel_err(b, w) for b, w in zip(bad, same))
        out["yardsticks"][what] = worst
        check(worst > BWD_REL, f"the bf16 gradient check missed the "
                               f"yardstick {what}: {worst}")
    return out


def time_bwd(q, k, v, do, lse, delta, seg, errs, lines, mode):
    """B2 and B3 timed alone, their plain versions, the bound of each,
    and the whole port step (B1 + Delta + B2 + B3) beside SDPA's forward
    and backward. Dense mode fills the kernel lines (the train step's
    mode)."""
    from tosem_tpu_torch.ops import flash_attention as fa
    args = (q, k, v, do, lse, delta, seg, False, 1.0 / 8.0, "bthd")
    port_ms = cuda_ms(lambda: run_bwd(q, k, v, do, seg, False, "bthd"))
    sdpa_ms = cuda_ms(lambda: sdpa_fwd_bwd(q, k, v, do, seg))
    out = {"port_fwd_bwd_ms": port_ms, "sdpa_fwd_bwd_ms": sdpa_ms}
    for name, kern, plain, err in (
            ("flash_bwd_dkv", fa._flash_bwd_dkv_cuda,
             fa._flash_bwd_dkv_torch, max(errs["dk"], errs["dv"])),
            ("flash_bwd_dq", fa._flash_bwd_dq_cuda, fa._flash_bwd_dq_torch,
             errs["dq"])):
        nbytes, ops = bwd_work(q, seg, name[len("flash_bwd_"):])
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        rec = {"ms": cuda_ms(lambda: kern(*args)),
               "plain_ms": cuda_ms(lambda: plain(*args), iters=5),
               "bound_ms": b_ms, "bound_by": b_by,
               # no single PyTorch call computes this kernel's function:
               # the yardstick is SDPA's forward + backward, combined
               "library_ms": sdpa_ms, "library_is": "sdpa fwd+bwd, "
               "combined; compare port_fwd_bwd_ms",
               "port_fwd_bwd_ms": port_ms, "max_abs_err": err,
               "dtype": "bfloat16", "shape": list(q.shape), "mode": mode}
        out[name] = rec
        if mode == "dense":
            lines[name] = rec
    return out


def paged_case(dev, dtype, lens, K, gen, page=128, H=12, D=64):
    import torch
    tdt = getattr(torch, dtype)
    B = len(lens)
    W = max(1, -(-max(lens) // page))
    P = 64
    kp = torch.randn(P, page, H, D, generator=gen).to(tdt).to(dev)
    vp = torch.randn(P, page, H, D, generator=gen).to(tdt).to(dev)
    bt = torch.randperm(P, generator=gen)[:B * W].reshape(B, W)
    bt = bt.to(torch.int32).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    shape = (B, H, D) if K == 0 else (B, K, H, D)
    q = torch.randn(*shape, generator=gen).to(tdt).to(dev)
    return q, kp, vp, bt, sl


def paged_work(q, lens, K, page=128):
    """(bytes, operations): q, the K/V of each sequence's cached tokens,
    tables and lengths read once, the output written once; 4*D per
    visible (row, key) pair."""
    H, D = q.shape[-2], q.shape[-1]
    el = q.element_size()
    rows = max(K, 1)
    toks = sum(lens)
    nbytes = (2 * q.numel() * el + 2 * toks * H * D * el
              + 4 * len(lens) * (2 + -(-max(lens) // page)))
    pairs = sum(max(0, sl - rows + 1 + r) for sl in lens if sl > 0
                for r in range(rows))
    return nbytes, 4 * D * H * pairs


def phase_kernels(dev, seed):
    import torch
    from tosem_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator().manual_seed(seed)
    cases = []
    lines = {}
    # ---- B1: dense, causal and segments at [1,512] and [8,128], a
    # ragged length, and the encode batch's shape; bf16 and fp32
    b1_cases = [(mode, B, T) for B, T in ((1, 512), (8, 128))
                for mode in ("dense", "causal", "segments")]
    b1_cases += [("causal", 1, 333), ("segments", 8, 512)]
    for dtype in ("bfloat16", "float32"):
        for mode, B, T in b1_cases:
            q, k, v, seg = flash_case(dev, dtype, B, T, mode, gen)
            causal = mode == "causal"
            out, lse = run_flash(q, k, v, seg, causal)
            ref, ref_lse = plain_flash(q, k, v, seg, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            check(err <= TOL["flash"][dtype],
                  f"flash {mode} {dtype} [{B},{T}] err {err}")
            check(lse_err <= 1e-3, f"flash lse {mode} {dtype} {lse_err}")
            rec = {"kernel": "flash_fwd", "mode": mode, "dtype": dtype,
                   "shape": [B, T, 12, 64], "max_abs_err": err,
                   "lse_err": lse_err}
            if (mode, B, T) in (("segments", 8, 512), ("causal", 1, 512)):
                nbytes, ops = flash_work(q, seg, causal)
                rec["ms"] = cuda_ms(lambda: run_flash(q, k, v, seg, causal))
                rec["plain_ms"] = cuda_ms(
                    lambda: plain_flash(q, k, v, seg, causal), iters=5)
                rec["library_ms"] = cuda_ms(lambda: sdpa(q, k, v, seg,
                                                         causal))
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
                if (mode, dtype) == ("segments", "bfloat16"):
                    lines["flash_fwd"] = rec
            cases.append(rec)
    # ---- B4: 8 sequences with ragged lengths up to 512, one idle row
    lens = [0, 1, 77, 128, 129, 300, 511, 512]
    for dtype in ("bfloat16", "float32"):
        q, kp, vp, bt, sl = paged_case(dev, dtype, lens, 0, gen)
        out = pa._paged_decode_cuda(q, kp, vp, bt, sl, 1.0 / 8.0)
        ref = pa.paged_attention_reference(q, kp, vp, bt, sl)
        multi1 = pa._paged_decode_multi_cuda(q[:, None].contiguous(), kp, vp,
                                             bt, sl, None, None, 1.0 / 8.0,
                                             None)[:, 0]
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(err <= TOL["paged"][dtype], f"paged_decode {dtype} err {err}")
        check(bool((out[0] == 0).all().item()), "seq_len 0 row not zeros")
        check(torch.equal(out, multi1), f"B5 k=1 != B4 bit for bit ({dtype})")
        rec = {"kernel": "paged_decode", "dtype": dtype, "lens": lens,
               "max_abs_err": err, "zeros_row_exact": True,
               "b5_k1_bit_exact": True}
        if dtype == "bfloat16":
            nbytes, ops = paged_work(q, lens, 0)
            rec["ms"] = cuda_ms(lambda: pa._paged_decode_cuda(
                q, kp, vp, bt, sl, 1.0 / 8.0), iters=50)
            rec["plain_ms"] = cuda_ms(lambda: pa.paged_attention_reference(
                q, kp, vp, bt, sl), iters=10)
            rec["library_ms"] = None
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
            lines["paged_decode"] = rec
        cases.append(rec)
    # ---- B5: k = 1, 8, 64 rows (64 = the suffix-prefill chunk)
    for dtype in ("bfloat16", "float32"):
        for K, lens5, q_rows in ((1, [300, 0, 45], None),
                                 (8, [129, 400, 8], None),
                                 (64, [320], [64]), (64, [300], [44])):
            q, kp, vp, bt, sl = paged_case(dev, dtype, lens5, K, gen)
            kr = (None if q_rows is None else
                  torch.tensor(q_rows, dtype=torch.int32, device=dev))
            out = pa._paged_decode_multi_cuda(q, kp, vp, bt, sl, kr, None,
                                              1.0 / 8.0, None)
            ref = pa.paged_attention_reference(q, kp, vp, bt, sl, q_rows=kr)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= TOL["paged"][dtype],
                  f"paged_decode_multi k={K} {dtype} err {err}")
            rec = {"kernel": "paged_decode_multi", "dtype": dtype, "k": K,
                   "lens": lens5, "q_rows": q_rows, "max_abs_err": err}
            if (K, dtype, q_rows) == (64, "bfloat16", [64]):
                nbytes, ops = paged_work(q, lens5, K)
                rec["ms"] = cuda_ms(lambda: pa._paged_decode_multi_cuda(
                    q, kp, vp, bt, sl, kr, None, 1.0 / 8.0, None), iters=50)
                rec["plain_ms"] = cuda_ms(
                    lambda: pa.paged_attention_reference(
                        q, kp, vp, bt, sl, q_rows=kr), iters=5)
                rec["library_ms"] = None
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
                lines["paged_decode_multi"] = rec
            cases.append(rec)
    cases += bwd_cases(dev, gen, lines)
    emit({"phase": "kernels", "cases": cases})
    return lines


# ------------------------------------------------------------ main paths


def phase_decode(dev, seed, new_tokens):
    import numpy as np
    import torch
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    rng = np.random.default_rng(seed)
    kw = dict(preset="base", max_batch=8, num_pages=64,
              max_new_tokens=new_tokens, device=dev, seed=seed)
    be = BertDecodeBackend(**kw)
    vocab = be.cfg.vocab_size
    lens = [int(n) for n in rng.integers(100, 401, size=8)]
    lens[0] = max(lens[0], 300)          # the prefix-hit donor
    prompts = [[int(t) for t in rng.integers(0, vocab, size=n)]
               for n in lens]
    suffix = [int(t) for t in rng.integers(0, vocab, size=60)]
    hit_prompt = prompts[0][:256] + suffix
    # warm-up request (under one page, so it leaves no prefix entry):
    # first-call library set-up stays out of the timed admits
    be.call({"ids": prompts[1][:50], "max_new_tokens": 2})
    torch.cuda.synchronize()

    registry.reset_launch_counts()
    t0 = time.perf_counter()
    ttft = []
    for i, p in enumerate(prompts):
        a = time.perf_counter()
        out = be.admit(i, {"ids": p})
        ttft.append((time.perf_counter() - a) * 1e3)
        check(not out["done"], f"prompt {i} finished at admit")
    t_admit = time.perf_counter() - t0
    step = 0
    live = list(range(8))
    t1 = time.perf_counter()
    while live:
        outs = be.step_batch(live, [step] * len(live))
        for sid, o in zip(list(live), outs):
            check("token" in o, f"step {step} seq {sid}: {o}")
            if o["done"]:
                live.remove(sid)
        step += 1
    t_steps = time.perf_counter() - t1
    streams = [be.result(i)["generated"] for i in range(8)]
    for s in streams:
        check(len(s) == new_tokens, f"stream length {len(s)}")
    a = time.perf_counter()
    out = be.admit("hit", {"ids": hit_prompt})
    ttft_hit = (time.perf_counter() - a) * 1e3
    st = be.cache_stats()
    n = 0
    while not out["done"]:
        out = be.step_batch(["hit"], [n])[0]
        n += 1
    hit_stream = be.result("hit")["generated"]
    counts = dict(registry.LAUNCH_COUNTS)
    for name in ("flash_fwd", "paged_decode", "paged_decode_multi"):
        check(counts[name] > 0, f"{name} never launched on the decode path")
    check(st["prefix_hits"] >= 1, f"no prefix hit: {st}")

    cold = BertDecodeBackend(prefix_cache=False, **kw)
    cold_stream = cold.call({"ids": hit_prompt})["generated"]
    check(hit_stream == cold_stream,
          f"prefix-hit stream {hit_stream} != cold stream {cold_stream}")
    gen_tokens = 8 * (new_tokens - 1)
    emit({"phase": "decode", "prompt_lens": lens,
          "ttft_ms": ttft, "ttft_ms_mean": sum(ttft) / len(ttft),
          "admit_s": t_admit, "steps": step, "step_s": t_steps,
          "decode_tokens_per_s": gen_tokens / t_steps,
          "ms_per_step": t_steps / step * 1e3,
          "prefix_hit_ttft_ms": ttft_hit, "prefix_hits": st["prefix_hits"],
          "reused_tokens": st["reused_tokens"],
          "hit_equals_cold": True, "launches": counts,
          "stream0_head": streams[0][:8]})
    del be, cold
    torch.cuda.empty_cache()
    return counts


def phase_encode(dev, seed):
    import numpy as np
    import torch
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.serve.backends import BertEncodeBackend
    rng = np.random.default_rng(seed + 1)
    be = BertEncodeBackend(preset="base", max_batch=8, device=dev,
                           seed=seed)
    lens = [int(n) for n in rng.integers(30, 501, size=8)]
    reqs = [{"ids": [int(t) for t in rng.integers(0, be.cfg.vocab_size,
                                                  size=n)]} for n in lens]
    be.call_batch(reqs)          # first call: cuBLAS and allocator set-up
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    outs = be.call_batch(reqs)
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(registry.LAUNCH_COUNTS)
    check(counts["flash_fwd"] > 0, "flash_fwd never launched on encode")
    for r, n in zip(outs, lens):
        check(r["len"] == n and r["pooled"].shape == (be.cfg.dim,)
              and np.isfinite(r["pooled"]).all(), f"bad encoding {r}")
    emit({"phase": "encode", "lens": lens, "batch_ms": ms,
          "flash_launches": counts["flash_fwd"], "launches": counts})
    del be
    torch.cuda.empty_cache()
    return counts


def phase_cpu(dev, seed, prompts=3):
    """The card against the CPU on the same weights: first-step logits of
    ``prompts`` 24-token prompts, fp32 and bf16. Two yardsticks read in
    the same run: the card's bf16 logits against the CPU's fp32 ones
    (bf16 rounding alone; the bf16 weights are the fp32 ones rounded),
    and a deliberately wrong CPU model, its layer-0 query projection
    scaled by 1.1 (a 10% softmax-temperature error in one layer of
    twelve), against the card on the first prompt."""
    import numpy as np
    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    ids = [torch.as_tensor(np.random.default_rng(seed + 2 + i).integers(
        0, 30522, size=(1, 24)), dtype=torch.int32) for i in range(prompts)]
    mask = torch.ones_like(ids[0])

    def first_logits(m, x):
        lg, _, _ = m.prefill_fn()(x.to(m.device), mask.to(m.device))
        return lg[0, -1].float().cpu()

    def gap(a, b):
        return (a - b).abs().max().item()

    lg = {}
    for dtype in ("float32", "bfloat16"):
        for where in (dev, "cpu"):
            m = Bert(BertConfig(dtype=dtype), device=where, seed=seed)
            lg[dtype, where] = [first_logits(m, x) for x in ids]
        with torch.no_grad():
            m.layers[0].attn.q.w.mul_(1.1)
        lg[dtype, "wrong"] = first_logits(m, ids[0])
        del m
    dts = ("float32", "bfloat16")
    sound = {dt: [gap(c, h) for c, h in zip(lg[dt, dev], lg[dt, "cpu"])]
             for dt in dts}
    scale = {dt: max(h.abs().max().item() for h in lg[dt, "cpu"])
             for dt in dts}
    wrong = {dt: gap(lg[dt, dev][0], lg[dt, "wrong"]) for dt in dts}
    rounding = [gap(c, h) for c, h in zip(lg["bfloat16", dev],
                                          lg["float32", "cpu"])]
    same = {dt: [int(c.argmax()) == int(h.argmax())
                 for c, h in zip(lg[dt, dev], lg[dt, "cpu"])] for dt in dts}
    for dt in dts:
        check(all(torch.isfinite(c).all().item() for c in lg[dt, dev]),
              f"non-finite {dt} logits on the card")
    # fp32 is held to 1e-3 absolute, and the wrong model must break it;
    # bf16 rounds every layer's output (12 layers, other summation orders
    # on each device), so it is held to 2e-2 of the largest logit
    check(max(sound["float32"]) <= 1e-3,
          f"fp32 cuda vs cpu first-step logits differ: {sound}")
    check(wrong["float32"] > 1e-3,
          f"the fp32 check cannot see the wrong model: {wrong}")
    check(max(sound["bfloat16"]) <= 2e-2 * max(1.0, scale["bfloat16"]),
          f"bf16 cuda vs cpu first-step logits differ: {sound}, "
          f"largest logit {scale}")
    emit({"phase": "cpu", "prompt_len": 24, "prompts": prompts,
          "max_abs_diff": sound, "max_abs_logit": scale,
          "bf16_limit": 2e-2 * max(1.0, scale["bfloat16"]),
          "card_bf16_vs_cpu_fp32": rounding,
          "wrong_model_vs_card": wrong, "same_argmax": same})


def _device_breakdown(prof, wall_ms, traced_ms, n, top=8):
    """Device time per iteration from a profiler trace, over the wall
    time of ``n`` iterations run without the profiler (``wall_ms``) and
    under it (``traced_ms``): the device's busy share of the unprofiled
    wall time, and the kernels that took most of the device time."""
    import collections

    import torch
    per = collections.Counter()
    for e in prof.events():
        # a user annotation (the optimizer's step range) spans kernels
        # that the trace also lists: count the kernels only
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            per[e.name] += e.time_range.elapsed_us() / 1e3 / n
    busy = sum(per.values())
    return {"wall_ms": wall_ms / n, "traced_wall_ms": traced_ms / n,
            "device_ms": busy, "device_busy_share": busy / (wall_ms / n),
            "top": [[name[:80], ms] for name, ms in per.most_common(top)]}


def _timed(fn, prof=None):
    """Host-clock ms of ``fn()`` up to a device sync, optionally traced."""
    import contextlib

    import torch
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def phase_profile(dev, seed, steps=5):
    """Where the time goes, over decode steps of 8 packed sequences, a
    384-token prefill and a padded encode batch. Each is run once without
    the profiler for its wall time, then once more under it for its
    device time: the next ``steps`` decode steps (a token longer each),
    another 384-token prompt, the same encode batch."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tosem_tpu_torch.serve.backends import (BertDecodeBackend,
                                                BertEncodeBackend)
    rng = np.random.default_rng(seed)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def rand_ids(n):
        return [int(t) for t in rng.integers(0, 30522, int(n))]

    be = BertDecodeBackend(preset="base", max_batch=8, num_pages=64,
                           max_new_tokens=2 * steps + 4, device=dev,
                           seed=seed)
    for i in range(8):
        be.admit(i, {"ids": rand_ids(rng.integers(100, 401))})
    be.step_batch(list(range(8)), [0] * 8)
    torch.cuda.synchronize()

    def run_steps(first):
        for k in range(first, first + steps):
            be.step_batch(list(range(8)), [k] * 8)
    wall = _timed(lambda: run_steps(1))
    prof = profile(activities=acts)
    traced = _timed(lambda: run_steps(1 + steps), prof)
    decode = _device_breakdown(prof, wall, traced, steps)
    wall = _timed(lambda: be.admit("p0", {"ids": rand_ids(384)}))
    prof = profile(activities=acts)
    traced = _timed(lambda: be.admit("p1", {"ids": rand_ids(384)}), prof)
    prefill = _device_breakdown(prof, wall, traced, 1)
    del be
    enc = BertEncodeBackend(preset="base", max_batch=8, device=dev, seed=seed)
    reqs = [{"ids": rand_ids(n)} for n in rng.integers(30, 501, size=8)]
    enc.call_batch(reqs)
    torch.cuda.synchronize()
    wall = _timed(lambda: enc.call_batch(reqs))
    prof = profile(activities=acts)
    traced = _timed(lambda: enc.call_batch(reqs), prof)
    encode = _device_breakdown(prof, wall, traced, 1)
    emit({"phase": "profile", "decode_step": decode,
          "prefill_384": prefill, "encode_batch": encode})


class _Preempt:
    """A chaos controller that preempts ``fit`` after step ``at``."""

    def __init__(self, at):
        self.at = at

    def on(self, site, **ctx):
        if site == "train.step" and ctx.get("step") == self.at:
            return {"action": "preempt"}
        return None


def _mlm_batch(ids, masked, mask=None):
    batch = {"ids": ids, "labels": ids, "masked": masked}
    if mask is not None:
        batch["mask"] = mask
    return batch


def train_steps(model, init, batch, attn_fn, seed, warmup, steps):
    """The ``bert_train`` leg on the port: from the initial weights, a
    fresh adamw(1e-4), ``warmup`` steps, then ``steps`` timed steps on
    the same batch. Returns (state, step_fn, losses, ms per step,
    launches of the timed steps)."""
    import functools

    import torch
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.train import (adamw, create_train_state,
                                       make_train_step, mlm_loss)
    from tosem_tpu_torch.train.trainer import step_generator
    dev = batch["ids"].device
    model.load_state_dict(init)
    st = create_train_state(model, adamw(1e-4))
    step = make_train_step(model, st.optimizer,
                           functools.partial(mlm_loss, attn_fn=attn_fn))
    for i in range(warmup):
        st, _ = step(st, batch, step_generator(seed, i, dev))
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        st, met = step(st, batch, step_generator(seed, i, dev))
        losses.append(met["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return st, step, [float(x) for x in losses], ms, \
        dict(registry.LAUNCH_COUNTS)


GRAD_NAMES = ["tok.table"] + [f"layers.{i}.attn.{p}.w" for i in (0, 11)
                              for p in "qkvo"]


def train_grads(where, attn_fn, batch, seed, wrong=False):
    """One step's fp32 gradients (no TF32, dropout 0) of the tensors in
    GRAD_NAMES, on the CPU. ``wrong`` scales layer 0's query projection
    by 1.1 first: the yardstick the check must catch."""
    import dataclasses

    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.train import mlm_loss
    cfg = dataclasses.replace(BertConfig.base(), dtype="float32",
                              precision="float32", dropout=0.0)
    m = Bert(cfg, device=where, seed=seed)
    if wrong:
        with torch.no_grad():
            m.layers[0].attn.q.w.mul_(1.1)
    with precision("float32"):
        loss, _ = mlm_loss(m, {k: v.to(where) for k, v in batch.items()},
                           None, attn_fn=attn_fn)
        loss.backward()
    params = dict(m.named_parameters())
    return {n: params[n].grad.detach().float().cpu() for n in GRAD_NAMES}


def _rel_gaps(got, want):
    return {n: ((got[n] - want[n]).abs().max()
                / want[n].abs().max().clamp_min(1e-30)).item()
            for n in GRAD_NAMES}


def phase_train(dev, seed, steps=10, warmup=2):
    """The JAX package's ``bert_train`` leg (``tosem_tpu/cli.py``) on the
    port: BERT-base, bf16, dropout 0.1, weights from ``seed``, adamw(1e-4),
    an 8 x 512 batch of random ids from ``seed + 1`` with labels = ids and
    15% of positions masked. Flash attention (B1, B2, B3) against dense
    attention on the same weights and batch; the train FLOPs are the
    reference's count, 6*N*B*T + 3*12*L*B*T^2*dim."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.train.trainer import step_generator
    cfg = BertConfig.base()
    B, T = 8, 512
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                          device=dev)
    masked = torch.as_tensor(rng.random((B, T)) < 0.15, device=dev)
    batch = _mlm_batch(ids, masked)
    model = Bert(cfg, device=dev, seed=seed)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    flops = 6 * n_params * B * T + 3 * 12 * cfg.layers * B * T * T * cfg.dim

    st, step, losses, flash_ms, counts = train_steps(
        model, init, batch, flash_attn_fn(), seed, warmup, steps)
    check(all(np.isfinite(losses)), f"non-finite train loss {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(counts[name] == 12 * steps,
              f"{name}: {counts[name]} launches in {steps} train steps")

    # one step on a padded batch: key padding rides B1-B3 as segment ids
    lens = [int(n) for n in rng.integers(30, 501, size=B)]
    pmask = torch.zeros(B, T, dtype=torch.int32)
    for b, n in enumerate(lens):
        pmask[b, :n] = 1
    pmask = pmask.to(dev)
    pbatch = _mlm_batch(ids * pmask, masked & pmask.bool(), pmask)
    registry.reset_launch_counts()
    st, met = step(st, pbatch, step_generator(seed, warmup + steps, dev))
    padded_loss = float(met["loss"])
    pcounts = dict(registry.LAUNCH_COUNTS)
    check(np.isfinite(padded_loss), f"padded batch loss {padded_loss}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(pcounts[name] == 12, f"{name}: {pcounts[name]} launches on "
                                   "the padded batch")
    launches = {k: counts[k] + pcounts[k] for k in KERNELS}

    # where the time goes: one step without the profiler, one under it
    wall = _timed(lambda: step(st, batch, step_generator(seed, 90, dev)))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced = _timed(lambda: step(st, batch, step_generator(seed, 91, dev)),
                    prof)
    breakdown = _device_breakdown(prof, wall, traced, 1, top=12)
    del st, step, prof
    torch.cuda.empty_cache()

    st, step, dense_losses, dense_ms, _ = train_steps(
        model, init, batch, None, seed, warmup, steps)
    check(all(np.isfinite(dense_losses)), f"dense loss {dense_losses}")
    mem = torch.cuda.max_memory_allocated() / 2**30
    del st, step, model, init
    torch.cuda.empty_cache()
    emit({"phase": "train", "config": "BERT-base bf16 dropout 0.1",
          "batch": [B, T], "params": n_params, "flops_per_step": flops,
          "warmup": warmup, "steps": steps, "losses": losses,
          "step_ms": flash_ms, "tokens_per_s": B * T / flash_ms * 1e3,
          "share_of_989_tflops": flops / (flash_ms * 1e-3) / 989e12,
          "dense_losses": dense_losses, "dense_step_ms": dense_ms,
          "flash_vs_dense_speedup": dense_ms / flash_ms,
          "padded_lens": lens, "padded_loss": padded_loss,
          "launches_timed_steps": counts, "launches_padded_step": pcounts,
          "max_memory_gib": mem, "profile": breakdown})
    return launches


def phase_train_grads(dev, seed):
    """fp32 gradients of one step at 2 x 128 (dropout 0, no TF32): the
    card's flash path against its dense path and against the CPU's plain
    path, each as the largest gap over the largest gradient, per tensor;
    a CPU model made wrong on purpose must fail the same check."""
    import numpy as np
    import torch
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    rng = np.random.default_rng(seed + 3)
    ids = torch.as_tensor(rng.integers(0, 30522, (2, 128)))
    batch = _mlm_batch(ids, torch.as_tensor(rng.random((2, 128)) < 0.15))
    card = train_grads(dev, flash_attn_fn(), batch, seed)
    dense = train_grads(dev, None, batch, seed)
    cpu = train_grads("cpu", flash_attn_fn(), batch, seed)
    wrong = train_grads("cpu", flash_attn_fn(), batch, seed, wrong=True)
    gaps = {"flash_vs_dense_card": _rel_gaps(card, dense),
            "card_vs_cpu": _rel_gaps(card, cpu),
            "card_vs_wrong_cpu": _rel_gaps(card, wrong)}
    limit = 1e-3
    for what in ("flash_vs_dense_card", "card_vs_cpu"):
        check(max(gaps[what].values()) <= limit,
              f"fp32 gradients {what} beyond {limit}: {gaps[what]}")
    check(max(gaps["card_vs_wrong_cpu"].values()) > limit,
          f"the gradient check cannot see the wrong model: {gaps}")
    emit({"phase": "train_grads", "batch": [2, 128], "limit": limit,
          "relative_gaps": gaps})


def phase_train_remat(dev, seed):
    """One BERT-base train step (bf16, dropout 0.1 from a generator on the
    card, flash attention, 8 x 512) with ``remat`` full and dots against
    none, from the same weights and generator seed: loss and every
    gradient bit for bit. ``torch.utils.checkpoint`` replays only the
    default generators, so this fails if a recomputed layer draws new
    dropout masks from the step's generator."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.train import mlm_loss
    from tosem_tpu_torch.train.trainer import step_generator
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, 30522, (8, 512)), device=dev)
    batch = _mlm_batch(ids, torch.as_tensor(rng.random((8, 512)) < 0.15,
                                            device=dev))
    loss_fn = functools.partial(mlm_loss, attn_fn=flash_attn_fn())
    out = {}
    for remat in ("none", "full", "dots"):
        model = Bert(dataclasses.replace(BertConfig.base(), remat=remat),
                     device=dev, seed=seed)
        torch.cuda.reset_peak_memory_stats()
        loss, _ = loss_fn(model, batch, step_generator(seed, 0, dev))
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()
                                      if p.grad is not None},
                      torch.cuda.max_memory_allocated() / 2**30)
        del model
    base = out["none"]
    for remat in ("full", "dots"):
        loss, grads, _ = out[remat]
        check(torch.equal(loss, base[0]),
              f"remat={remat} loss {loss.item()} != {base[0].item()}")
        check(grads.keys() == base[1].keys() and
              all(torch.equal(grads[n], base[1][n]) for n in base[1]),
              f"remat={remat} gradients differ from remat=none")
    emit({"phase": "train_remat", "loss": base[0].item(), "bit_exact": True,
          "peak_gib": {k: v[2] for k, v in out.items()}})
    del out, base
    torch.cuda.empty_cache()


def phase_train_resume(dev, seed, layers=2, steps=4):
    """``fit`` at BERT-base width with ``layers`` layers (bf16, dropout
    0.1, flash attention, 8 x 512): the loss history of a run preempted
    through the chaos hook after step 3 and resumed from its step-2
    checkpoint equals the uninterrupted run's bit for bit, with
    PyTorch's default (non-deterministic-algorithm) settings."""
    import dataclasses
    import functools
    import tempfile

    import numpy as np
    import torch
    from tosem_tpu_torch.chaos import install, uninstall
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.train import (TrainingPreempted, adamw,
                                       create_train_state, fit,
                                       make_train_step, mlm_loss)
    cfg = dataclasses.replace(BertConfig.base(), layers=layers)

    def batch_fn(step):
        rng = np.random.default_rng([seed, step])
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 512)),
                              device=dev)
        return _mlm_batch(ids, torch.as_tensor(rng.random((8, 512)) < 0.15,
                                               device=dev))

    def run(**kw):
        model = Bert(cfg, device=dev, seed=seed)
        st = create_train_state(model, adamw(1e-4))
        step = make_train_step(model, st.optimizer, functools.partial(
            mlm_loss, attn_fn=flash_attn_fn()))
        return fit(st, step, batch_fn, steps, seed=seed, **kw)[1]

    t0 = time.perf_counter()
    want = run()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_ckpt_") as ck:
        install(_Preempt(3))
        try:
            run(ckpt_dir=ck, checkpoint_every=2)
            preempted = False
        except TrainingPreempted:
            preempted = True
        finally:
            uninstall()
        saved = sorted(os.listdir(ck))
        got = run(ckpt_dir=ck, checkpoint_every=2)
    check(preempted, "the chaos hook did not preempt fit")
    check(saved == ["ckpt_00000002"], f"checkpoints at preemption: {saved}")
    check(got == want, f"resumed history {got} != uninterrupted {want}")
    torch.cuda.empty_cache()
    emit({"phase": "train_resume", "layers": layers, "steps": steps,
          "preempted_after": 3, "checkpoints_at_preemption": saved,
          "history": [h["loss"] for h in want], "bit_exact": True,
          "seconds": time.perf_counter() - t0})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,decode,encode,cpu,profile,train")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not os.path.isdir(os.path.join(ROOT, "tosem_tpu_torch")):
        print("tosem_tpu_torch/ is not beside chip_smoke.py: run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tosem_tpu_torch.ops import _build
    dev = "cuda"
    gpu = gpu_line()
    t0 = time.perf_counter()
    took = _build.build_all(verbose_ptxas=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": took, "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "ptxas": {k: ptxas_summary(v[1])
                    for k, v in _build.BUILD_LOG.items()}})
    lines = phase_kernels(dev, SEED) if "kernels" in phases else {}
    launches = {k: 0 for k in KERNELS}
    if "decode" in phases:
        for k, n in phase_decode(dev, SEED, NEW_TOKENS).items():
            launches[k] += n
    if "encode" in phases:
        for k, n in phase_encode(dev, SEED).items():
            launches[k] += n
    if "cpu" in phases:
        phase_cpu(dev, SEED)
    if "profile" in phases:
        phase_profile(dev, SEED)
    if "train" in phases:
        for k, n in phase_train(dev, SEED).items():
            launches[k] += n
        phase_train_grads(dev, SEED)
        phase_train_remat(dev, SEED)
        phase_train_resume(dev, SEED)
    src = "tosem_tpu_torch/ops/csrc/"
    meta = {"flash_fwd": ("flash_fwd.cu",
                          "tosem_tpu/ops/flash_attention.py:272"),
            "flash_bwd_dkv": ("flash_bwd.cu",
                              "tosem_tpu/ops/flash_attention.py:402"),
            "flash_bwd_dq": ("flash_bwd.cu",
                             "tosem_tpu/ops/flash_attention.py:471"),
            "paged_decode": ("paged_decode.cu",
                             "tosem_tpu/ops/paged_attention.py:101"),
            "paged_decode_multi": ("paged_decode.cu",
                                   "tosem_tpu/ops/paged_attention.py:225")}
    kernels = []
    for name, (f, replaces) in meta.items():
        rec = lines.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": src + f,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rec.get("max_abs_err"),
                        "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
                        "bound_ms": rec.get("bound_ms"),
                        "bound_by": rec.get("bound_by"),
                        "library_ms": rec.get("library_ms"),
                        "library_is": rec.get("library_is"),
                        "port_fwd_bwd_ms": rec.get("port_fwd_bwd_ms"),
                        "dtype": rec.get("dtype"),
                        "shape": rec.get("shape") or rec.get("lens")})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
