"""The port's exporter (``compile/export.py``): ``export_program`` writes
a ``torch.export`` program (``.pt2``) that reloads and gives the eager
output, and a ``.meta`` whose lines equal the JAX package's for the same
shapes; ``pattern_fill`` and ``_dtype_name`` are the reference's. The
reference's side lowers the same function's JAX twin (a product and a
sum of squares), so the two ``.meta`` files are compared line for
line."""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


class _Twin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(6, 5, generator=g))

    def forward(self, x, s):
        y = x @ self.w
        return y, (y * y).sum(-1) + s


def test_meta_lines_equal_the_reference_s(tmp_path):
    import jax.numpy as jnp
    from tosem_tpu.compile.export import export_program as ref_export
    from tosem_tpu_torch.compile.export import export_program
    w = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)

    def twin(x, s):
        y = x @ w
        return y, (y * y).sum(-1) + s
    ref_paths = ref_export(twin, (jnp.zeros((3, 4, 6)), jnp.zeros(())),
                           str(tmp_path / "ref"), "twin",
                           roles=["data", "eps"])
    paths = export_program(_Twin(), (torch.zeros(3, 4, 6),
                                     torch.zeros(())),
                           str(tmp_path / "port"), "twin",
                           roles=["data", "eps"])
    assert sorted(paths) == ["meta", "pt2"]
    assert open(paths["meta"]).read() == open(ref_paths["meta"]).read()
    assert open(paths["meta"]).read().splitlines() == [
        "in data f32 3 4 6", "in eps f32", "out data f32 3 4 5",
        "out data f32 3 4"]


def test_pt2_reloads_and_matches_eager(tmp_path):
    from tosem_tpu_torch.compile.export import export_program
    m = _Twin()
    x = torch.randn(3, 4, 6, generator=torch.Generator().manual_seed(1))
    s = torch.tensor(0.5)
    paths = export_program(m, (x, s), str(tmp_path), "twin")
    assert os.path.getsize(paths["pt2"]) > 0
    loaded = torch.export.load(paths["pt2"]).module()
    with torch.no_grad():
        got, want = loaded(x, s), m(x, s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_function_exports_with_what_it_closes_over(tmp_path):
    from tosem_tpu_torch.compile.export import export_program
    m = _Twin()
    x = torch.randn(2, 4, 6, generator=torch.Generator().manual_seed(2))
    paths = export_program(lambda x: m(x, torch.zeros(()))[0], (x,),
                           str(tmp_path), "fn")
    assert open(paths["meta"]).read().splitlines() == [
        "in data f32 2 4 6", "out data f32 2 4 5"]
    with torch.no_grad():
        assert torch.equal(torch.export.load(paths["pt2"]).module()(x),
                           x @ m.w)


@pytest.mark.parametrize("shape,dtype", [((3, 5), "float32"), ((), "float32"),
                                         ((300,), "int32"),
                                         ((4, 70), "bfloat16")])
def test_pattern_fill_and_dtype_names_equal_the_reference_s(shape, dtype):
    import jax.numpy as jnp
    from tosem_tpu.compile.export import _dtype_name as ref_name
    from tosem_tpu.compile.export import pattern_fill as ref_fill
    from tosem_tpu_torch.compile.export import _dtype_name, pattern_fill
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref_fill(shape, jdt)).astype(np.float32)
    got = pattern_fill(shape, tdt)
    assert got.dtype == tdt and tuple(got.shape) == tuple(shape)
    assert np.array_equal(got.float().numpy(), want)
    assert _dtype_name(tdt) == ref_name(jdt)
    if dtype != "bfloat16":
        assert _dtype_name(np.dtype(dtype)) == ref_name(jdt)
