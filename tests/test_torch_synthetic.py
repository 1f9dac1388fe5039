"""The port's synthetic datasets (``tosem_tpu_torch/data/synthetic.py``)
equal the JAX package's bit for bit: both are seeded numpy."""
import numpy as np
import pytest


def _both():
    from tosem_tpu.data import synthetic as ref
    from tosem_tpu_torch.data import synthetic as port
    return ref, port


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,hw,classes,seed", [(512, 32, 10, 0),
                                               (64, 8, 4, 3)])
def test_image_dataset_and_val_split(n, hw, classes, seed):
    ref, port = _both()
    r = ref.SyntheticImageDataset(n=n, hw=hw, classes=classes, seed=seed)
    p = port.SyntheticImageDataset(n=n, hw=hw, classes=classes, seed=seed)
    for a, b in zip(r.materialize(), p.materialize()):
        _equal(a, b)
    for a, b in zip(r.materialize_val(32), p.materialize_val(32)):
        _equal(a, b)


@pytest.mark.parametrize("batch,kw", [(16, dict(n=64, hw=8, classes=4)),
                                      (8, dict(seed=2))])
def test_cifar_like_batches(batch, kw):
    ref, port = _both()
    got = list(port.cifar_like_batches(batch, steps=3, **kw))
    want = list(ref.cifar_like_batches(batch, steps=3, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "label"}
        for k in g:
            _equal(g[k], w[k])


@pytest.mark.parametrize("seed", [0, 5])
def test_mlm_batches(seed):
    ref, port = _both()
    got = list(port.mlm_batches(4, 16, 64, steps=2, seed=seed))
    want = list(ref.mlm_batches(4, 16, 64, steps=2, seed=seed))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            _equal(g[k], w[k])


def test_port_exports_and_imports_no_jax():
    import subprocess
    import sys
    code = ("import sys; import tosem_tpu_torch.data as d; "
            "d.cifar_like_batches; d.mlm_batches; d.SyntheticImageDataset; "
            "assert 'jax' not in sys.modules and 'tosem_tpu' not in "
            "sys.modules")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
