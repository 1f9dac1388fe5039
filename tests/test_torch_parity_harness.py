"""The port's kernel parity harness (``tosem_tpu_torch/ops/parity.py``):
copies of ``tests/test_parity_harness.py`` over the port's arms and
oracles, and the harness held against the JAX package's.

On the CPU the port has one arm a family (``torch``), so each cell holds
it to the numpy oracle and to the JAX package's ``xla`` lowering on the
same case (the two packages' cases hold the same values), at the JAX
package's ``TOLERANCES``; on a card the cell runs the (``cuda``,
``torch``) pair as well."""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.ops import parity, registry

torch.set_num_threads(1)

_CELLS = [(fam, sc) for fam in parity.FAMILIES
          for sc in parity.scenarios(fam)]


def _ref_sc(sc):
    from tosem_tpu.ops import parity as ref
    return next(s for s in ref.scenarios(sc.family)
                if s.name == sc.name and s.dtype == sc.dtype)


def test_matrices_and_tolerances_are_the_reference_s():
    from tosem_tpu.ops import parity as ref
    assert parity.TOLERANCES == ref.TOLERANCES
    for fam in parity.FAMILIES:
        assert [(s.name, s.dtype, s.params) for s in parity.scenarios(fam)] \
            == [(s.name, s.dtype, s.params) for s in ref.scenarios(fam)]


@pytest.mark.parametrize("family,sc", _CELLS, ids=[str(s) for _, s in
                                                   _CELLS])
def test_all_available_pairs_agree(family, sc):
    from tosem_tpu.ops import parity as ref
    for a, b in parity.available_pairs(family):
        parity.check_pair(family, a, b, sc)
    parity.check_oracle(family, registry.BACKEND_TORCH, sc)
    # the same cell against the JAX package's xla lowering
    args, kwargs = parity.build_case(sc)
    want = ref._run_cell(family, "xla", _ref_sc(sc), 0)
    got = parity._run_cell(family, registry.BACKEND_TORCH, sc, 0)
    parity._assert_close(got, want, parity.TOLERANCES[family][sc.dtype],
                         family, sc, "torch vs reference xla", args, kwargs)


@pytest.mark.parametrize("family", parity.FAMILIES)
def test_cases_equal_the_reference_s(family):
    from tosem_tpu.ops import parity as ref
    for sc in parity.scenarios(family):
        rargs, rkw = ref.build_case(_ref_sc(sc))
        args, kw = parity.build_case(sc)
        for r, p in zip(rargs, args):
            r = np.asarray(r)
            want = r if r.dtype == np.int32 else r.astype(np.float32)
            np.testing.assert_array_equal(parity._np(p).astype(want.dtype),
                                          want)
        for k in ("window", "causal", "layout"):
            assert kw.get(k) == rkw.get(k)


class TestOraclePins:
    def test_windowed_multi_q_vs_dense_oracle(self):
        sc = [s for s in parity.scenarios("paged")
              if s.name == "window_multi_q"][0]
        for backend in parity.available_backends("paged"):
            parity.check_oracle("paged", backend, sc)

    def test_rolling_offsets_vs_dense_oracle(self):
        sc = [s for s in parity.scenarios("paged")
              if s.name == "window_offsets"][0]
        for backend in parity.available_backends("paged"):
            parity.check_oracle("paged", backend, sc)

    def test_multihead_segments_vs_dense_oracle(self):
        sc = [s for s in parity.scenarios("schedule")
              if s.name == "multihead_segments"][0]
        for backend in parity.available_backends("schedule"):
            parity.check_oracle("schedule", backend, sc)

    @pytest.mark.parametrize("family", ["flash", "schedule"])
    def test_default_backend_vs_dense_oracle_sample(self, family):
        backend = registry.resolve(family, platform="cpu")
        for sc in parity.scenarios(family, "float32")[:3]:
            parity.check_oracle(family, backend, sc)


class TestHarnessMechanics:
    def test_build_case_is_deterministic(self):
        sc = parity.scenarios("paged")[0]
        (q1, *_), _ = parity.build_case(sc)
        (q2, *_), _ = parity.build_case(sc)
        assert torch.equal(q1, q2)

    def test_pairs_are_strict(self):
        """An arm runs on its own platform only: the cuda arm over the
        CPU's case raises instead of self-checking the torch arm."""
        sc = parity.scenarios("flash")[0]
        args, kwargs = parity.build_case(sc)
        with pytest.raises(registry.BackendUnavailable):
            parity.run_arm("flash", registry.BACKEND_CUDA, args, kwargs)
        if not torch.cuda.is_available():
            assert parity.available_pairs("flash") == []
            assert parity.available_backends("flash") == ("torch",)
        assert parity.available_pairs("flash", "cuda") == [("cuda",
                                                             "torch")]

    def test_violation_reports_scenario_and_pair(self):
        sc = parity.scenarios("flash")[0]
        with pytest.raises(AssertionError, match="parity.*vs"):
            parity.check_oracle("flash", registry.BACKEND_TORCH, sc,
                                atol=0.0)

    def test_a_dropped_mask_breaks_the_check(self):
        """The yardstick: the local-mask cell run without its mask."""
        sc = [s for s in parity.scenarios("flash")
              if s.name == "local_mask"][0]
        args, kwargs = parity.build_case(sc)
        want = parity._dense_mask_oracle(*args, kwargs)
        dropped = {k: v for k, v in kwargs.items() if k != "mask"}
        with torch.no_grad():
            got = parity._np(parity.run_arm("flash", "torch", args,
                                            dropped))
        with pytest.raises(AssertionError, match="parity"):
            parity._assert_close(got, want, parity.TOLERANCES["flash"][
                sc.dtype], "flash", sc, "dropped mask vs oracle", args,
                kwargs)

    def test_run_matrix_covers_every_cell(self):
        recs = parity.run_matrix(families=("paged",))
        pairs = {tuple(r["pair"]) for r in recs}
        want = set(parity.available_pairs("paged")) or {("torch",
                                                         "oracle")}
        assert pairs == want
        assert len(recs) == len(pairs) * len(parity.scenarios("paged"))
