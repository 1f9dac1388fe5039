"""The port's BERT held against the JAX package's, on the JAX package's
own initial weights carried across by ``bert_params_from_numpy``, at
``BertConfig.tiny()`` in fp32 (2e-5), plus the layer traps of a JAX ->
PyTorch translation pinned one by one."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    import jax
    from tosem_tpu.models.bert import Bert as JBert
    from tosem_tpu.models.bert import BertConfig as JConfig
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.models.convert import load_bert_params
    jcfg = dataclasses.replace(JConfig.tiny(), dtype="float32")
    jm = JBert(jcfg)
    vs = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, vs["params"])
    pm = Bert(BertConfig(**dataclasses.asdict(jcfg)), device="cpu", seed=1)
    load_bert_params(pm, tree)
    return jm, vs, pm, tree


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) \
        else x.detach().float().numpy()


def _ids(rng, B, T, vocab=128):
    return rng.integers(0, vocab, size=(B, T)).astype(np.int32)


def test_converter_covers_every_parameter(pair):
    jm, vs, pm, tree = pair
    from tosem_tpu_torch.models.convert import bert_params_from_numpy
    sd = bert_params_from_numpy(tree)
    assert set(sd) == set(pm.state_dict())
    assert sd["layers.1.attn.q.w"].shape == (32, 32)
    np.testing.assert_array_equal(sd["layers.0.fc1.w"].numpy(),
                                  tree["layer0"]["fc1"]["w"])


def test_converter_keeps_bf16_bits():
    import ml_dtypes
    from tosem_tpu_torch.models.convert import array_to_tensor
    a = np.asarray([1.0, -2.5, 3.140625, 1e-3], ml_dtypes.bfloat16)
    t = array_to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_encode_with_padding_mask_matches(pair, attn):
    import jax.numpy as jnp
    from tosem_tpu.nn.attention import flash_attn_fn as j_flash
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    jm, vs, pm, _ = pair
    rng = np.random.default_rng(0)
    ids = _ids(rng, 3, 40)
    mask = np.ones((3, 40), np.int32)
    mask[0, 25:] = 0
    mask[2, 7:] = 0
    ref = jm.encode_fn(vs, attn_fn=j_flash() if attn == "flash" else None)(
        jnp.asarray(ids), jnp.asarray(mask))
    got = pm.encode_fn(attn_fn=flash_attn_fn() if attn == "flash"
                       else None)(torch.from_numpy(ids),
                                  torch.from_numpy(mask))
    assert np.abs(_np(got) - _np(ref)).max() <= TOL


def test_mlm_logits_match(pair):
    import jax.numpy as jnp
    jm, vs, pm, _ = pair
    rng = np.random.default_rng(1)
    ids = _ids(rng, 2, 16)
    enc = jm.apply(vs, jnp.asarray(ids))[0]
    ref = jm.mlm_logits(vs, enc)
    got = pm.mlm_logits(pm.apply(torch.from_numpy(ids)))
    assert got.dtype == torch.float32
    assert np.abs(_np(got) - _np(ref)).max() <= TOL


def _prefill_both(pair, ids):
    import jax.numpy as jnp
    jm, vs, pm, _ = pair
    mask = np.ones_like(ids)
    ref = jm.prefill_fn(vs)(jnp.asarray(ids), jnp.asarray(mask))
    got = pm.prefill_fn()(torch.from_numpy(ids), torch.from_numpy(mask))
    return ref, got


def test_prefill_logits_and_kv_match(pair):
    rng = np.random.default_rng(2)
    ref, got = _prefill_both(pair, _ids(rng, 2, 24))
    for r, g in zip(ref, got):
        assert tuple(r.shape) == tuple(g.shape)
        assert np.abs(_np(g) - _np(r)).max() <= TOL


def _pools_from(pair, ids, page, P, table):
    """Both packages' pools holding the prefill K/V of ``ids`` [1, T] at
    the pages ``table`` names."""
    import jax.numpy as jnp
    (rl, rk, rv), _ = _prefill_both(pair, ids)
    L, _, T, H, D = rk.shape
    kp = np.zeros((L, P, page, H, D), np.float32)
    vp = np.zeros_like(kp)
    for t in range(T):
        kp[:, table[t // page], t % page] = np.asarray(rk)[:, 0, t]
        vp[:, table[t // page], t % page] = np.asarray(rv)[:, 0, t]
    return (jnp.asarray(kp), jnp.asarray(vp),
            torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))


def test_decode_step_matches_with_an_inactive_row(pair):
    import jax.numpy as jnp
    jm, vs, pm, _ = pair
    page, P = 8, 12
    rng = np.random.default_rng(3)
    prompt = _ids(rng, 1, 13)
    table = np.asarray([5, 2, 9, 0], np.int32)
    jk, jv, tk, tv = _pools_from(pair, prompt, page, P, table)
    ids = np.asarray([7, 3, 0], np.int32)
    positions = np.asarray([13, 13, 4], np.int32)     # row 2: anywhere
    tables = np.stack([table, table, np.zeros(4, np.int32)])
    lens = np.asarray([14, 14, 0], np.int32)
    rl, rk, rv = jm.decode_step_fn(vs, page_size=page)(
        *(jnp.asarray(a) for a in (ids, positions)), jk, jv,
        jnp.asarray(tables), jnp.asarray(lens))
    gl, gk, gv = pm.decode_step_fn(page_size=page)(
        *(torch.from_numpy(a) for a in (ids, positions)), tk, tv,
        torch.from_numpy(tables), torch.from_numpy(lens))
    assert gk is tk                          # pools updated in place
    assert np.abs(_np(gl)[:2] - _np(rl)[:2]).max() <= TOL
    # the inactive row wrote nothing: page 0 slot 4 is still zero
    assert torch.all(gk[:, 0, 4] == 0)
    assert np.abs(_np(gk) - _np(rk)).max() <= TOL
    assert np.abs(_np(gv) - _np(rv)).max() <= TOL


def test_decode_multi_matches_with_ragged_rows(pair):
    import jax.numpy as jnp
    jm, vs, pm, _ = pair
    page, P, K = 8, 12, 4
    rng = np.random.default_rng(4)
    prompt = _ids(rng, 1, 11)
    table = np.asarray([3, 7, 1, 0], np.int32)
    jk, jv, tk, tv = _pools_from(pair, prompt, page, P, table)
    ids = np.asarray([[5, 6, 7, 7], [1, 2, 2, 2]], np.int32)
    positions = np.asarray([[11, 12, 13, 13], [11, 12, 12, 12]], np.int32)
    tables = np.stack([table, table])
    lens = np.asarray([14, 0], np.int32)
    q_rows = np.asarray([3, 2], np.int32)
    offs = np.zeros(2, np.int32)
    args = (ids, positions)
    rest = (tables, lens, q_rows, offs)
    rl, rk, rv = jm.decode_multi_fn(vs, page_size=page, q_tokens=K)(
        *(jnp.asarray(a) for a in args), jk, jv,
        *(jnp.asarray(a) for a in rest))
    gl, gk, gv = pm.decode_multi_fn(page_size=page, q_tokens=K)(
        *(torch.from_numpy(a) for a in args), tk, tv,
        *(torch.from_numpy(a) for a in rest))
    assert np.abs(_np(gl)[0, :3] - _np(rl)[0, :3]).max() <= TOL
    assert np.abs(_np(gk) - _np(rk)).max() <= TOL
    assert np.abs(_np(gv) - _np(rv)).max() <= TOL


def _greedy(step, prefill, prompt, page, P, steps, to_arr, pools):
    """Greedy loop: prefill, then one-token steps; returns the tokens."""
    logits, k, v = prefill(to_arr(prompt), to_arr(np.ones_like(prompt)))
    T = prompt.shape[1]
    kp, vp = pools
    table = np.arange(P, dtype=np.int32)[None, :]
    for t in range(T):
        kp, vp = _write(kp, vp, k[:, 0, t], v[:, 0, t], t // page, t % page)
    tok = int(np.argmax(_np(logits)[0, T - 1]))
    out = [tok]
    for s in range(steps - 1):
        pos = T + s
        lg, kp, vp = step(to_arr(np.asarray([tok], np.int32)),
                          to_arr(np.asarray([pos], np.int32)), kp, vp,
                          to_arr(table), to_arr(np.asarray([pos + 1],
                                                           np.int32)))
        tok = int(np.argmax(_np(lg)[0]))
        out.append(tok)
    return out


def _write(kp, vp, k, v, page, row):
    if torch.is_tensor(kp):
        kp[:, page, row] = k
        vp[:, page, row] = v
        return kp, vp
    return kp.at[:, page, row].set(k), vp.at[:, page, row].set(v)


def test_greedy_token_streams_identical(pair):
    import jax.numpy as jnp
    jm, vs, pm, _ = pair
    page, P, steps = 8, 8, 12
    rng = np.random.default_rng(5)
    prompt = _ids(rng, 1, 19)
    shape = (2, P, page, 2, 16)
    ref = _greedy(jm.decode_step_fn(vs, page_size=page), jm.prefill_fn(vs),
                  prompt, page, P, steps, jnp.asarray,
                  (jnp.zeros(shape), jnp.zeros(shape)))
    got = _greedy(pm.decode_step_fn(page_size=page), pm.prefill_fn(),
                  prompt, page, P, steps, torch.from_numpy,
                  (torch.zeros(shape), torch.zeros(shape)))
    assert len(got) == steps and got == ref


# ------------------------------------------------------------ layer traps


def test_gelu_is_the_tanh_approximation():
    import jax
    import jax.numpy as jnp
    from tosem_tpu_torch.nn.layers import gelu
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - ref).max() > 1e-4      # torch's default differs


def test_layernorm_bf16_casts_before_the_affine():
    import jax.numpy as jnp
    from tosem_tpu.nn.core import variables
    from tosem_tpu.nn.layers import LayerNorm as JLN
    from tosem_tpu_torch.nn.layers import LayerNorm
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 32)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    bf = jnp.bfloat16
    ref = JLN(32, dtype=bf).apply(
        variables({"scale": jnp.asarray(scale).astype(bf),
                   "bias": jnp.asarray(bias).astype(bf)}),
        jnp.asarray(x).astype(bf))[0]
    ln = LayerNorm(32, dtype=torch.bfloat16)
    ln.scale.data = torch.from_numpy(scale).bfloat16()
    ln.bias.data = torch.from_numpy(bias).bfloat16()
    xb = torch.from_numpy(x).bfloat16()
    got = ln(xb).detach()                # the layer's parameters train
    assert got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    assert np.abs(got.float().numpy() - ref32).max() <= 2e-2
    # the fused order (affine in fp32, then cast) is a different layer
    xf = xb.float()
    y = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, unbiased=False, keepdim=True) + 1e-6)
    fused = (y * ln.scale.float() + ln.bias.float()).bfloat16()
    assert not torch.equal(fused, got)
    assert ln.eps == 1e-6


def test_lm_head_promotes_the_table_to_fp32():
    from tosem_tpu_torch.nn.layers import Embedding
    emb = Embedding(16, 8, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    out = emb.attend(x)
    assert out.dtype == torch.float32
    assert torch.equal(out, x @ emb.table.float().t())


def test_embedding_gather_raises_where_jnp_take_clamps():
    from tosem_tpu_torch.nn.layers import Embedding
    emb = Embedding(16, 8)
    with pytest.raises(IndexError):
        emb(torch.tensor([3, 16]))


def test_dense_attention_masks_with_finfo_min():
    import jax.numpy as jnp
    from tosem_tpu.nn.attention import dot_product_attention as j_dpa
    from tosem_tpu_torch.nn.attention import dot_product_attention
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((2, 2, 6, 6)) < 0.6
    mask[0, 0, 2] = False                   # a query row seeing no key
    ref = j_dpa(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    got = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(mask))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL
    # finfo.min leaves a fully masked row a uniform average of v
    np.testing.assert_allclose(got[0, 2, 0].numpy(),
                               v[0, :, 0].mean(0), atol=1e-6)


def test_flash_attn_fn_counts_the_dense_mask_fallback():
    from tosem_tpu_torch.nn import attention
    from tosem_tpu_torch.ops import registry
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 6, 2, 8, generator=g) for _ in range(3))
    mask = torch.rand(1, 1, 6, 6, generator=g) < 0.7
    mask[..., 0] = True
    before = registry.FALLBACK_COUNTS["flash:torch->dense"]
    got = attention.flash_attn_fn()(q, k, v, mask)
    assert registry.FALLBACK_COUNTS["flash:torch->dense"] == before + 1
    assert torch.equal(got, attention.dot_product_attention(q, k, v, mask))
    kv_mask = torch.ones(1, 1, 1, 6, dtype=torch.bool)
    flash = attention.FLASH_DISPATCH_COUNTS["flash"]
    attention.flash_attn_fn()(q, k, v, kv_mask)
    assert attention.FLASH_DISPATCH_COUNTS["flash"] == flash + 1


@pytest.mark.parametrize("change", [{"moe_experts": 4},
                                    {"moe_experts": 2, "moe_every": 1}])
def test_unported_variants_raise(change):
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    cfg = dataclasses.replace(BertConfig.tiny(), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Bert(cfg, device="cpu")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_models_build_but_do_not_decode(remat):
    """Remat belongs to training (``tests/test_torch_train.py`` holds its
    gradients); the decode path refuses it, as the JAX package's does."""
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    m = Bert(dataclasses.replace(BertConfig.tiny(), remat=remat),
             device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        m.prefill_fn()
    with pytest.raises(ValueError, match="remat"):
        Bert(dataclasses.replace(BertConfig.tiny(), remat="some"),
             device="cpu")
