"""BERT encoder and its causal-decoder member, in PyTorch.

Counterpart of ``tosem_tpu/models/bert.py``: the same configuration, the
same pre-LN layer math and parameter names, and the same entry points —
``apply``/``encode_fn`` (encoder), ``prefill_fn`` (causal forward that
also returns per-layer K/V), ``decode_step_fn`` and ``decode_multi_fn``
(one or K tokens per sequence over the paged KV cache).

Differences in idiom: the model is a ``torch.nn.Module`` that owns its
parameters (``Bert(cfg, device=..., seed=...)``, or load a converted
tree with :func:`tosem_tpu_torch.models.convert.bert_params_from_numpy`);
``apply`` is differentiable (the training path), while ``encode_fn``,
``prefill_fn`` and the decode functions run under ``torch.no_grad()``, so
serving builds no graph. The decode functions write K/V into the pools
IN PLACE and return the same pool tensors, where the JAX functions
returned new pools. A padding row's K/V is never written (the JAX code
relied on an out-of-bounds scatter being dropped; on CUDA that index is
a device-side assert).

Dropout draws from the ``generator`` passed to ``apply`` (a
``torch.Generator`` on the model's device; None = the device's default
generator), where the JAX package splits an ``rng`` key per layer.
``remat="full"`` recomputes each encoder layer in the backward pass
(``torch.utils.checkpoint``, non-reentrant); ``remat="dots"`` saves the
layer's ``Dense`` matmul outputs and recomputes the rest, the counterpart
of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``. A
checkpointed layer sets the generator back to the state it had before
the layer when it is recomputed, so the recomputation draws the same
dropout masks (``torch.utils.checkpoint`` replays the default
generators only).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from tosem_tpu_torch.nn.attention import MultiHeadAttention
from tosem_tpu_torch.nn.layers import (Dense, Dropout, Embedding, LayerNorm,
                                       base_generator, gelu)
from tosem_tpu_torch.ops.common import resolve_device


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_len: int = 512
    dim: int = 768
    heads: int = 12
    layers: int = 12
    mlp_dim: int = 3072
    dropout: float = 0.1
    dtype: str = "bfloat16"
    precision: str = "default"
    remat: str = "none"          # none | full | dots
    moe_experts: int = 0
    moe_every: int = 2
    moe_k: int = 2
    moe_capacity_factor: float = 1.25

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        """CI-sized config (same topology, 2 layers)."""
        return cls(vocab_size=128, max_len=64, dim=32, heads=2, layers=2,
                   mlp_dim=64, dropout=0.0)


# rows in one LM-head GEMM of the decode steps (Bert._head_rows): one
# tile holds a greedy step of 8 rows or a speculative step of 8 x 4
HEAD_ROWS = 32


def _norm(ln, x, per_row):
    """``ln(x)``, or its row-invariant form (``LayerNorm.rows``): the
    decode steps' layernorms."""
    return ln.rows(x) if per_row else ln(x)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, str(name))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        dt = _torch_dtype(cfg.dtype)
        self.ln1 = LayerNorm(cfg.dim, dtype=dt)
        self.attn = MultiHeadAttention(cfg.dim, cfg.heads,
                                       dropout=cfg.dropout, dtype=dt,
                                       precision=cfg.precision,
                                       generator=generator)
        self.ln2 = LayerNorm(cfg.dim, dtype=dt)
        self.fc1 = Dense(cfg.dim, cfg.mlp_dim, dtype=dt,
                         precision=cfg.precision, init_std=0.02,
                         generator=generator)
        self.fc2 = Dense(cfg.mlp_dim, cfg.dim, dtype=dt,
                         precision=cfg.precision, init_std=0.02,
                         generator=generator)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x, *, mask=None, train=False, attn_fn=None,
                generator=None):
        h = self.attn(self.ln1(x), mask=mask, train=train, attn_fn=attn_fn,
                      generator=generator)
        x = x + h
        h = self.fc2(gelu(self.fc1(self.ln2(x))))
        h = self.drop(h, train=train, generator=generator)
        return x + h

    def mlp_residual(self, x, per_row=False):
        """The layer's second half (eval): ``x + fc2(gelu(fc1(ln2(x))))``;
        ``per_row`` takes ln2's row-invariant form."""
        return x + self.fc2(gelu(self.fc1(_norm(self.ln2, x, per_row))))

    def qkv(self, x, shape, per_row=False):
        """ln1 then the q/k/v projections, reshaped to ``shape``;
        ``per_row`` takes ln1's row-invariant form."""
        h = _norm(self.ln1, x, per_row)
        a = self.attn
        return (a.q(h).reshape(shape), a.k(h).reshape(shape),
                a.v(h).reshape(shape))


class MoEEncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        raise NotImplementedError(
            "MoE BERT layers are not ported yet (ROADMAP.md A13: nn/moe.py)")


class Bert(nn.Module):
    """``Bert(cfg, device="cuda", seed=0)``. With no card present the
    default device raises; tests pass ``device="cpu"``."""

    def __init__(self, cfg: BertConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if cfg.moe_experts:
            MoEEncoderLayer(cfg)
        if cfg.remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat mode {cfg.remat!r}; "
                             "expected none|full|dots")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(int(seed))
        dt = _torch_dtype(cfg.dtype)
        self.tok = Embedding(cfg.vocab_size, cfg.dim, dtype=dt,
                             generator=gen)
        self.pos = Embedding(cfg.max_len, cfg.dim, dtype=dt, generator=gen)
        self.seg = Embedding(2, cfg.dim, dtype=dt, generator=gen)
        self.ln_emb = LayerNorm(cfg.dim, dtype=dt)
        self.layers = nn.ModuleList(EncoderLayer(cfg, gen)
                                    for _ in range(cfg.layers))
        self.ln_out = LayerNorm(cfg.dim, dtype=dt)
        self.drop = Dropout(cfg.dropout)
        self.to(dev)
        self.device = dev

    # ------------------------------------------------------------ encoder

    def apply(self, ids, *, segments=None, mask=None, train=False,
              attn_fn=None, generator=None):
        """ids: [B, T] int. mask: [B, T] (1 = real token) or None.
        Returns [B, T, dim] encodings. Differentiable; ``generator``
        drives dropout when ``train``."""
        B, T = ids.shape
        pos_ids = torch.arange(T, device=ids.device)[None, :]
        h = self.tok(ids) + self.pos(pos_ids)
        if segments is not None:
            h = h + self.seg(segments)
        h = self.ln_emb(h)
        attn_mask = None
        if mask is not None:
            attn_mask = mask[:, None, None, :].bool()
        h = self.drop(h, train=train, generator=generator)
        for layer in self.layers:
            h = self._run_layer(layer, h, attn_mask, train, attn_fn,
                                generator)
        return self.ln_out(h)

    def _run_layer(self, layer, h, mask, train, attn_fn, generator):
        def run(x):
            return layer(x, mask=mask, train=train, attn_fn=attn_fn,
                         generator=generator)
        if self.cfg.remat == "none" or not torch.is_grad_enabled():
            return run(h)
        if train and self.cfg.dropout > 0 and \
                base_generator(generator) is not None:
            run = _replaying(run, base_generator(generator))
        kw = {"context_fn": _dots_contexts} if self.cfg.remat == "dots" \
            else {}
        return _ckpt.checkpoint(run, h, use_reentrant=False, **kw)

    def mlm_logits(self, encodings):
        """Tied-embedding masked-LM head (fp32)."""
        return self.tok.attend(encodings.float())

    def encode_fn(self, *, attn_fn=None):
        """``fwd(ids, mask) -> encodings``; with
        ``attn_fn=flash_attn_fn()`` the key-padding mask rides the flash
        kernel as segment ids."""
        @torch.no_grad()
        def fwd(ids, mask):
            return self.apply(ids, mask=mask, train=False, attn_fn=attn_fn)
        return fwd

    # ------------------------------------------------------- decode path

    def _check_decodable(self) -> None:
        if self.cfg.moe_experts:
            raise ValueError("decode path supports dense-FFN configs "
                             "only (moe_experts must be 0)")
        if self.cfg.remat != "none":
            raise ValueError("decode path is inference-only; set "
                             "remat='none'")

    def _embed(self, ids, pos_ids, per_row=False):
        """Shared embedding stack (ids + pos -> ln_emb), eval mode."""
        return _norm(self.ln_emb, self.tok(ids) + self.pos(pos_ids), per_row)

    def _head(self, h):
        return self.tok.attend(self.ln_out(h).float())

    def _head_rows(self, h):
        """The decode steps' LM head: ``h`` [..., dim] -> fp32 logits
        [..., vocab], ``ln_out``'s row-invariant form, then the rows in
        tiles of :data:`HEAD_ROWS` (the last padded with zeros), one GEMM
        of one shape a tile. cuBLAS picks its GEMM by the row count, so a
        row gets the same bits whether 8 rows (a greedy step) or 32 (a
        speculative step of 4) share the call."""
        x = self.ln_out.rows(h).float()
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        n = x.shape[0]
        if n % HEAD_ROWS:
            x = torch.cat([x, x.new_zeros(HEAD_ROWS - n % HEAD_ROWS,
                                          x.shape[1])])
        tiles = [self.tok.attend(t) for t in x.split(HEAD_ROWS)]
        out = tiles[0] if len(tiles) == 1 else torch.cat(tiles)
        return out[:n].reshape(*lead, -1)

    def prefill_fn(self, *, attn_fn=None):
        """Causal prefill: ``fwd(ids [B,T], mask [B,T]) -> (logits
        [B,T,vocab] fp32, k [L,B,T,H,Dh], v [L,B,T,H,Dh])``. ``attn_fn``
        defaults to the flash kernel with ``causal=True``; pads at the
        end of a prompt never reach real positions, so ``mask`` only
        says which logits the caller trusts."""
        self._check_decodable()
        from tosem_tpu_torch.nn.attention import flash_attn_fn
        core = attn_fn or flash_attn_fn(causal=True)

        @torch.no_grad()
        def fwd(ids, mask):
            B, T = ids.shape
            h = self._embed(ids, torch.arange(T, device=ids.device)[None])
            ks, vs = [], []
            for layer in self.layers:
                h, k_l, v_l = _decode_layer_full(layer, h, core)
                ks.append(k_l)
                vs.append(v_l)
            return self._head(h), torch.stack(ks), torch.stack(vs)
        return fwd

    def decode_step_fn(self, *, page_size: int, backend=None):
        """One-token decode step over the paged cache: ``fwd(ids [B],
        positions [B], k_pool, v_pool [L,P,page,H,Dh], block_tables
        [B,max_pages], seq_lens [B]) -> (logits [B,vocab], k_pool,
        v_pool)``. ``seq_lens`` include the current token; inactive rows
        carry ``seq_lens == 0``, write no K/V and attend to zeros. The
        pools are updated in place and returned."""
        self._check_decodable()

        @torch.no_grad()
        def fwd(ids, positions, k_pool, v_pool, block_tables, seq_lens):
            h = self._embed(ids[:, None], positions[:, None],
                            per_row=True)[:, 0]
            act = torch.nonzero(seq_lens > 0).flatten()
            pos_a = positions[act].long()
            pages = block_tables[act, pos_a // page_size].long()
            rows = pos_a % page_size
            for i, layer in enumerate(self.layers):
                h = _decode_layer_step(layer, h, i, k_pool, v_pool, act,
                                       pages, rows, block_tables, seq_lens,
                                       backend)
            return self._head_rows(h), k_pool, v_pool
        return fwd

    def decode_multi_fn(self, *, page_size: int, q_tokens: int,
                        window: Optional[int] = None, backend=None):
        """K-token decode step: ``fwd(ids [B,K], positions [B,K], k_pool,
        v_pool, block_tables [B,W], seq_lens [B], q_rows [B],
        page_offsets [B]) -> (logits [B,K,vocab], k_pool, v_pool)``. Row
        r of an active sequence feeds the token at ``positions[b, r]``
        (the last ``q_rows[b]`` positions, ending at ``seq_lens[b] - 1``)
        and its logits score the next position, exactly as ``q_rows[b]``
        sequential one-token steps would. Padding columns (r >=
        q_rows[b]) write no K/V and give logits the caller ignores."""
        self._check_decodable()
        if q_tokens < 1:
            raise ValueError(f"q_tokens {q_tokens} must be >= 1")
        K = q_tokens

        @torch.no_grad()
        def fwd(ids, positions, k_pool, v_pool, block_tables, seq_lens,
                q_rows, page_offsets):
            sl = seq_lens.to(torch.int32)
            kr = q_rows.to(torch.int32)
            po = page_offsets.to(torch.int32)
            h = self._embed(ids, positions, per_row=True)  # [B, K, dim]
            col = torch.arange(K, device=ids.device)[None, :]
            active = (sl[:, None] > 0) & (col < kr[:, None])
            b_a, r_a = torch.nonzero(active, as_tuple=True)
            pos_a = positions[b_a, r_a].long()
            slot = pos_a // page_size - po[b_a].long()
            pages = block_tables[b_a, slot].long()
            rows = pos_a % page_size
            for i, layer in enumerate(self.layers):
                h = _decode_layer_multi(layer, h, i, k_pool, v_pool,
                                        (b_a, r_a), pages, rows,
                                        block_tables, sl, kr, po, backend,
                                        window)
            return self._head_rows(h), k_pool, v_pool
        return fwd


def _replaying(run, generator):
    """``run`` wrapped so that every call after the first starts from the
    generator state the first call started from, and leaves the
    generator where it was: a recomputed layer draws the forward's
    dropout masks and moves no later draw."""
    start = generator.get_state()
    calls = []

    def replay(x):
        after = generator.get_state() if calls else None
        calls.append(1)
        generator.set_state(start)
        try:
            return run(x)
        finally:
            if after is not None:
                generator.set_state(after)
    return replay


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dimensions (the
    ``Dense`` projections), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return _ckpt.create_selective_checkpoint_contexts(_dots_policy)


def _decode_layer_full(layer, x, core):
    """EncoderLayer forward with the K/V projections surfaced (prefill)."""
    B, T, _ = x.shape
    attn = layer.attn
    q, k, v = layer.qkv(x, (B, T, attn.heads, attn.head_dim))
    out = attn.o(core(q, k, v, None).reshape(B, T, attn.dim))
    return layer.mlp_residual(x + out), k, v


def _decode_layer_step(layer, x, layer_idx, k_pool, v_pool, act, pages,
                       rows, block_tables, seq_lens, backend):
    """One layer of the one-token step: project q/k/v, write the active
    rows' K/V into their page slots, attend over the paged cache (which
    now holds the token itself), then the residual/MLP chain."""
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    B = x.shape[0]
    attn = layer.attn
    q, k, v = layer.qkv(x, (B, attn.heads, attn.head_dim), per_row=True)
    k_pool[layer_idx, pages, rows] = k[act].to(k_pool.dtype)
    v_pool[layer_idx, pages, rows] = v[act].to(v_pool.dtype)
    out = paged_attention(q, k_pool[layer_idx], v_pool[layer_idx],
                          block_tables, seq_lens, backend=backend)
    out = attn.o(out.reshape(B, attn.dim).to(x.dtype))
    return layer.mlp_residual(x + out, per_row=True)


def _decode_layer_multi(layer, x, layer_idx, k_pool, v_pool, act, pages,
                        rows, block_tables, seq_lens, q_rows, page_offsets,
                        backend, window):
    """One layer of the K-token step (the multi-query sibling of
    :func:`_decode_layer_step`)."""
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    B, K, _ = x.shape
    attn = layer.attn
    q, k, v = layer.qkv(x, (B, K, attn.heads, attn.head_dim), per_row=True)
    k_pool[layer_idx, pages, rows] = k[act].to(k_pool.dtype)
    v_pool[layer_idx, pages, rows] = v[act].to(v_pool.dtype)
    out = paged_attention(q, k_pool[layer_idx], v_pool[layer_idx],
                          block_tables, seq_lens, backend=backend,
                          q_rows=q_rows, window=window,
                          page_offsets=page_offsets)
    out = attn.o(out.reshape(B, K, attn.dim).to(x.dtype))
    return layer.mlp_residual(x + out, per_row=True)


def pad_ids_batch(id_seqs, pad_to: int, pad_batch_to: int = 0):
    """Variable-length id sequences -> ``(ids [B, T] int32, mask [B, T]
    int32, lengths)`` numpy arrays with ``T = pad_to``; ``pad_batch_to``
    pads the batch too, filler rows keeping one real token."""
    import numpy as np
    B = len(id_seqs)
    BP = max(B, pad_batch_to)
    ids = np.zeros((BP, pad_to), np.int32)
    mask = np.zeros((BP, pad_to), np.int32)
    lengths = np.zeros((BP,), np.int32)
    for i, seq in enumerate(id_seqs):
        seq = np.asarray(seq, np.int32)
        if len(seq) > pad_to:
            raise ValueError(f"sequence {i} length {len(seq)} exceeds "
                             f"pad target {pad_to}")
        ids[i, :len(seq)] = seq
        mask[i, :len(seq)] = 1
        lengths[i] = len(seq)
    mask[B:, 0] = 1
    return ids, mask, lengths


def bert_base(*, device="cuda", seed: int = 0) -> Bert:
    return Bert(BertConfig.base(), device=device, seed=seed)


def bert_tiny(*, device="cuda", seed: int = 0) -> Bert:
    return Bert(BertConfig.tiny(), device=device, seed=seed)
