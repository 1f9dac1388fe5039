"""The port's MoE-BERT on the CPU.

The JAX package's ``tests/test_moe_bert.py`` (five cases) against the
port, then ``bert_tiny_moe(4)`` held to the JAX package's on its own
initial weights (carried by ``bert_params_from_numpy``, which names
``layer{i}/moe/{gate,w1,b1,w2,b2}`` like every other leaf): encodings,
MLM logits and the summed aux loss. In fp32 the encodings and logits
agree within 5e-5 and the aux within rel 1e-5; in the configs' own bf16
the encodings within 3e-2 of the largest value (each package rounds its
bf16 products its own way).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tosem_tpu_torch.models.bert import (Bert, BertConfig, bert_tiny,
                                         bert_tiny_moe)

torch.set_num_threads(1)

TOL = 5e-5


def _ids(seed, B, T, lo=0, hi=100):
    return np.random.default_rng(seed).integers(lo, hi, (B, T)).astype(
        np.int32)


def test_forward_shape_and_aux_in_state():
    b = bert_tiny_moe(4, device="cpu")
    ids = torch.arange(32, dtype=torch.long).reshape(2, 16) % 100
    with torch.no_grad():
        h, state = b.apply(ids, return_state=True)
    assert h.shape == (2, 16, b.cfg.dim)
    assert "moe_aux" in state
    assert float(state["moe_aux"]) >= 1.0 - 1e-4      # one routed layer
    dense = bert_tiny(device="cpu")
    _, sd = dense.apply(ids, return_state=True)
    assert "moe_aux" not in sd
    # without return_state an MoE model gives encodings alone
    with torch.no_grad():
        assert torch.equal(b.apply(ids), h)


def test_moe_has_more_params_same_interface():
    n_moe = sum(p.numel() for p in bert_tiny_moe(4, device="cpu")
                .parameters())
    n_dense = sum(p.numel() for p in bert_tiny(device="cpu").parameters())
    assert n_moe > 1.3 * n_dense


def test_bert_rules_shard_moe_experts():
    from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from tosem_tpu_torch.parallel.sharding import bert_rules, shard_tree
    mesh = make_mesh(MeshSpec.of(dp=2, tp=2, ep=2), ["cpu"] * 8)
    b = bert_tiny_moe(4, device="cpu")
    params = {n: p.detach() for n, p in b.named_parameters()}
    sharded = shard_tree(params, mesh, bert_rules(ep="ep"))
    moe_w1 = next(k for k in sharded if ".moe.w1" in k)
    assert sharded[moe_w1].spec[0] == "ep"
    assert sharded["layers.0.fc1.w"].spec[1] == "tp"


def test_low_expert_count_config_clamps_k():
    cfg = dataclasses.replace(BertConfig.tiny(), moe_experts=1)
    b = Bert(cfg, device="cpu")                     # must not raise
    assert b.layers[1].moe.k == 1
    h, st = b.apply(torch.zeros(1, 8, dtype=torch.long), return_state=True)
    assert "moe_aux" in st


def _moe_mlm_loss(b, ids):
    h, state = b.apply(ids, return_state=True)
    logp = torch.log_softmax(b.mlm_logits(h), -1)
    task = -logp.gather(-1, ids[..., None].long()).mean()
    return task + 0.01 * state["moe_aux"], task


def test_mlm_training_with_aux_loss():
    b = bert_tiny_moe(4, device="cpu")
    w_old = b.layers[1].moe.w1.detach().clone()
    ids = torch.from_numpy(_ids(0, 4, 16, 2, 100)).long()
    losses = []
    for _ in range(80):
        loss, task = _moe_mlm_loss(b, ids)
        b.zero_grad()
        loss.backward()
        with torch.no_grad():
            for p in b.parameters():
                if p.grad is not None:        # the unused segment table
                    p -= 0.1 * p.grad
        losses.append(float(task.detach()))
    assert losses[-1] < 0.4 * losses[0], (losses[0], losses[-1])
    # the experts trained (gradient reached them through the routing)
    assert float((b.layers[1].moe.w1.detach() - w_old).abs().max()) > 1e-6


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    import jax
    from tosem_tpu.models.bert import Bert as JBert
    from tosem_tpu.models.bert import bert_tiny_moe as j_tiny_moe
    from tosem_tpu_torch.models.convert import load_bert_params
    jcfg = dataclasses.replace(j_tiny_moe(4).cfg, dtype=dtype)
    jm = JBert(jcfg)
    vs = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, vs["params"])
    pm = Bert(BertConfig(**dataclasses.asdict(jcfg)), device="cpu", seed=1)
    load_bert_params(pm, tree)
    return jm, vs, pm, tree


@pytest.fixture(params=["float32", "bfloat16"])
def pair(request):
    return _pair(request.param)


def _gap(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max(), np.abs(want).max()


def test_converter_names_the_expert_stacks(pair):
    jm, vs, pm, tree = pair
    from tosem_tpu_torch.models.convert import bert_params_from_numpy
    sd = bert_params_from_numpy(tree)
    assert set(sd) == set(pm.state_dict())
    assert sd["layers.1.moe.w1"].shape == (4, 32, 64)
    np.testing.assert_array_equal(
        sd["layers.1.moe.gate"].float().numpy(),
        np.asarray(tree["layer1"]["moe"]["gate"], np.float32))


@pytest.mark.parametrize("padded", [False, True])
def test_encodings_aux_and_logits_match_the_reference(pair, padded):
    import jax.numpy as jnp
    jm, vs, pm, _ = pair
    ids = _ids(3, 3, 24, 0, 128)
    mask = np.ones_like(ids)
    if padded:
        mask[0, 17:] = 0
        mask[2, 5:] = 0
    h_ref, st_ref = jm.apply(vs, jnp.asarray(ids), mask=jnp.asarray(mask))
    logits_ref = jm.mlm_logits(vs, h_ref)
    h, st = pm.apply(torch.from_numpy(ids).long(),
                     mask=torch.from_numpy(mask), return_state=True)
    logits = pm.mlm_logits(h)
    fp32 = pm.cfg.dtype == "float32"
    gap, top = _gap(h, h_ref)
    assert gap <= (TOL if fp32 else 3e-2 * top)
    if fp32:
        assert _gap(logits, logits_ref)[0] <= TOL
        assert float(st["moe_aux"]) == pytest.approx(
            float(st_ref["moe_aux"]), rel=1e-5)
    else:
        gap, top = _gap(logits, logits_ref)
        assert gap <= 3e-2 * top
        assert float(st["moe_aux"]) == pytest.approx(
            float(st_ref["moe_aux"]), rel=1e-2)


def test_wrong_expert_breaks_the_match():
    """The fp32 check above must catch one expert's weights off by 10%."""
    import jax.numpy as jnp
    jm, vs, pm, tree = _pair("float32")
    ids = _ids(3, 3, 24, 0, 128)
    h_ref, _ = jm.apply(vs, jnp.asarray(ids))
    with torch.no_grad():
        pm.layers[1].moe.w2[2].mul_(1.1)
    try:
        assert _gap(pm.apply(torch.from_numpy(ids).long()), h_ref)[0] > TOL
    finally:
        with torch.no_grad():
            pm.layers[1].moe.w2[2].div_(1.1)


def test_remat_keeps_the_aux_and_its_gradient():
    """remat recomputes the routed layer in the backward: the loss, the
    aux and every gradient equal the un-rematerialised step's."""
    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(BertConfig.tiny(), moe_experts=4,
                                  dtype="float32", remat=remat)
        b = Bert(cfg, device="cpu", seed=2)
        loss, _ = _moe_mlm_loss(b, torch.from_numpy(_ids(5, 2, 16)).long())
        loss.backward()
        grads[remat] = (float(loss), {n: p.grad.clone() for n, p in
                                      b.named_parameters()
                                      if p.grad is not None})
    for remat in ("full", "dots"):
        assert grads[remat][0] == grads["none"][0]
        for n, g in grads["none"][1].items():
            assert torch.equal(grads[remat][1][n], g), (remat, n)
