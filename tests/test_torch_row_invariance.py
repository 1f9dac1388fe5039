"""C6's repair: a decode row gets the same bits whether 8 rows (a greedy
step) or 32 (a speculative step of 4) share the call.

The decode steps take ``nn/layers.LayerNorm.rows`` (fp32 statistics
from ``F.layer_norm``, one reduction layout a row) and run the LM head in
fixed tiles of ``HEAD_ROWS`` rows (``Bert._head_rows``). On the card
these are what make speculative rows equal greedy rows bit for bit
(``chip_smoke.py``'s decode_modes phase); here they are pinned at
BERT-base's width, and both LayerNorm forms are held to the JAX
package's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tosem_tpu_torch.models.bert import HEAD_ROWS, Bert, BertConfig
from tosem_tpu_torch.nn.layers import LayerNorm

torch.set_num_threads(1)


def _model(dtype):
    cfg = dataclasses.replace(BertConfig.base(), vocab_size=1000, layers=1,
                              mlp_dim=64, dtype=dtype)
    return Bert(cfg, device="cpu", seed=3)


def _rows(n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 768), generator=g).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_rows_same_among_8_and_32(dtype):
    ln = _model(dtype).layers[0].ln1
    x = _rows(32, dtype).reshape(8, 4, 768)
    with torch.no_grad():
        whole = ln.rows(x)
        for r in range(4):
            assert torch.equal(ln.rows(x[:, r].contiguous()), whole[:, r])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_rows_same_among_8_and_32(dtype):
    model = _model(dtype)
    x = _rows(32, dtype, seed=1).reshape(8, 4, 768)
    with torch.no_grad():
        whole = model._head_rows(x)
        assert whole.shape == (8, 4, 1000) and whole.dtype == torch.float32
        for r in range(4):
            assert torch.equal(model._head_rows(x[:, r].contiguous()),
                               whole[:, r])


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 70])
def test_head_rows_tile_and_pad(n):
    """Any row count runs in tiles of HEAD_ROWS: a row's logits are the
    ones it gets in a full tile, and the one-GEMM head's within fp32
    rounding."""
    model = _model("float32")
    x = _rows(70, "float32", seed=2)
    with torch.no_grad():
        full = torch.cat([model._head_rows(t) for t in x.split(HEAD_ROWS)])
        got = model._head_rows(x[:n])
        assert torch.equal(got, full[:n])
        np.testing.assert_allclose(got.numpy(), model._head(x[:n]).numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("form", ["forward", "rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_the_reference(dtype, form):
    """The JAX package's LayerNorm (fp32 statistics, cast, then the affine
    in the input dtype) on the same inputs and parameters, both forms."""
    import jax.numpy as jnp
    from tosem_tpu.nn.layers import LayerNorm as JLN
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 768)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(768).astype(np.float32)
    bias = rng.standard_normal(768).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jln = JLN(768, dtype=jdt)
    params = {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias,
                                                                    jdt)}
    want = np.asarray(jln.apply({"params": params, "state": {}},
                                jnp.asarray(x, jdt))[0]).astype(np.float32)
    tdt = getattr(torch, dtype)
    ln = LayerNorm(768, dtype=tdt)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = getattr(ln, form)(torch.from_numpy(x).to(tdt)).float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_decode_steps_use_the_tiled_head():
    """A speculative step's rows and the greedy steps' rows over the same
    cache, on the CPU: equal bit for bit (the card's pin)."""
    cfg = dataclasses.replace(BertConfig.tiny(), dtype="float32")
    model = Bert(cfg, device="cpu", seed=0)
    page, k = 8, 4
    L, H, D = cfg.layers, cfg.heads, cfg.dim // cfg.heads
    prompts = [[5, 9, 2, 7, 1], [3, 3, 8, 1, 4, 6, 2, 9, 9]]
    B = len(prompts)
    kp = torch.zeros(L, 8, page, H, D)
    vp = torch.zeros_like(kp)
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    prefill = model.prefill_fn(attn_fn=None)
    first = []
    for b, p in enumerate(prompts):
        ids = torch.tensor([p], dtype=torch.int32)
        lg, kk, vv = prefill(ids, torch.ones_like(ids))
        first.append(int(lg[0, -1].argmax()))
        for j in range(2):
            lo, hi = j * page, min(len(p), (j + 1) * page)
            if lo < hi:
                kp[:, tables[b, j], :hi - lo] = kk[:, 0, lo:hi]
                vp[:, tables[b, j], :hi - lo] = vv[:, 0, lo:hi]
    n = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    step = model.decode_step_fn(page_size=page)
    kg, vg = kp.clone(), vp.clone()
    tok = torch.tensor(first, dtype=torch.int32)
    fed, rows = [], []
    for r in range(k):
        fed.append(tok)
        lg, _, _ = step(tok, n + r, kg, vg, tables, n + r + 1)
        rows.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    multi = model.decode_multi_fn(page_size=page, q_tokens=k)
    pos = n[:, None] + torch.arange(k, dtype=torch.int32)[None]
    spec, _, _ = multi(torch.stack(fed, 1), pos, kp.clone(), vp.clone(),
                       tables, n + k, torch.full_like(n, k),
                       torch.zeros_like(n))
    for r in range(k):
        assert torch.equal(spec[:, r], rows[r])
