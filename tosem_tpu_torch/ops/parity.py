"""The kernel parity harness over the port's registry.

Counterpart of ``tosem_tpu/ops/parity.py`` (``Scenario``, ``scenarios``,
``build_case``, ``check_pair``, ``check_oracle``, ``available_pairs``,
``run_matrix``; the JAX package exports the last as
``run_kernel_parity``). Each family (flash, paged, schedule) declares the
JAX package's scenario matrix, its cases are built from the same seeded
numpy draws (so both packages' cases hold the same values), and
:func:`check_pair` holds two arms of a family to the JAX package's
per-dtype :data:`TOLERANCES`; :func:`check_oracle` holds one arm to a
brute-force numpy oracle.

**The pairs.** The JAX package pairs lowerings that run on one platform
(``pallas-interpret`` and ``xla`` on the CPU). The port's two backends
each run on one platform only (``ops/registry.py``): ``cuda`` on CUDA
tensors, ``torch`` on CPU tensors. So on the card the pair is (``cuda``
on the card, ``torch`` on CPU copies of the same case), and on the CPU
only the ``torch`` arm and the oracles run (:func:`available_pairs` is
empty there, and :func:`run_matrix` holds the ``torch`` arm to the
oracles instead).

**Block sizes.** The JAX package's cases pass ``BlockSizes(32, 32, 32,
32)`` so both of its lowerings execute one schedule. The port's kernels
have fixed 64 x 64 tiles (``ops/flash_blocks.py``) and its ``torch`` arm
folds a mask program into a dense ``where``, so the port's cases carry
no block sizes: which tiles a schedule skips changes no answer of a mask
program, only which blocks are computed.

The ``norms`` family (B6-B9) has no matrix here: ``chip_smoke.py``'s
kernels phase holds it against its plain version.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tosem_tpu_torch.ops import registry

# fp32: a few ulps of online-vs-dense softmax re-association; bf16
# operands round scores and probabilities to 8 mantissa bits first
TOLERANCES: Dict[str, Dict[str, float]] = {
    "flash": {"float32": 2e-5, "bfloat16": 2e-2},
    "paged": {"float32": 5e-6, "bfloat16": 2e-2},
    "schedule": {"float32": 2e-5, "bfloat16": 2e-2},
}

FAMILIES = ("flash", "paged", "schedule")


@dataclass(frozen=True)
class Scenario:
    """One cell of a family's parity matrix. ``params`` carries the
    family's knobs (mask spec, window, q_rows, segments, ...)."""
    family: str
    name: str
    dtype: str = "float32"
    params: tuple = field(default_factory=tuple)

    def p(self) -> dict:
        return dict(self.params)

    def __str__(self) -> str:                  # pytest id
        return f"{self.family}:{self.name}:{self.dtype}"


def _sc(family: str, name: str, dtype: str = "float32", **params):
    return Scenario(family, name, dtype, tuple(sorted(params.items())))


# the JAX package's matrices; tiny shapes, coverage from the mode axes

_FLASH_SCENARIOS: List[Scenario] = [
    _sc("flash", "dense"),
    _sc("flash", "dense", "bfloat16"),
    _sc("flash", "causal", causal=True),
    _sc("flash", "causal", "bfloat16", causal=True),
    _sc("flash", "segments", segments=True),
    _sc("flash", "causal_segments", causal=True, segments=True),
    _sc("flash", "bthd_layout", layout="bthd", causal=True),
    _sc("flash", "local_mask", mask="local:48"),
    _sc("flash", "prefix_mask", mask="prefix:32"),
    _sc("flash", "doc_mask", mask="doc:64"),
    _sc("flash", "doc_mask_segments", mask="doc:64", segments=True),
]

_PAGED_SCENARIOS: List[Scenario] = [
    _sc("paged", "ragged_lens", lens=(7, 0, 16)),
    _sc("paged", "ragged_lens", "bfloat16", lens=(9, 12)),
    _sc("paged", "single_full", lens=(32,)),
    _sc("paged", "multi_q", lens=(29, 17), k=4),
    _sc("paged", "multi_q_ragged_rows", lens=(29, 17), k=4,
        q_rows=(4, 3)),
    _sc("paged", "window", lens=(29, 17), k=2, window=10),
    _sc("paged", "window_multi_q", lens=(30, 20), k=4, window=12),
    _sc("paged", "window_offsets", lens=(30, 20), k=2, window=6,
        offsets=True),
]

_SCHEDULE_SCENARIOS: List[Scenario] = [
    _sc("schedule", "causal", mask="causal"),
    _sc("schedule", "local", mask="local:48"),
    _sc("schedule", "local", "bfloat16", mask="local:48"),
    _sc("schedule", "prefix", mask="prefix:40"),
    _sc("schedule", "doc", mask="doc:64"),
    _sc("schedule", "local_band", mask="local:32:31"),
    _sc("schedule", "multihead", multihead=True),
    _sc("schedule", "multihead_segments", multihead=True,
        segments=True),
    _sc("schedule", "doc_segments", mask="doc:64", segments=True),
]

_MATRIX: Dict[str, List[Scenario]] = {
    "flash": _FLASH_SCENARIOS,
    "paged": _PAGED_SCENARIOS,
    "schedule": _SCHEDULE_SCENARIOS,
}


def scenarios(family: str, dtype: Optional[str] = None) -> List[Scenario]:
    """The family's declared scenario matrix (optionally one dtype)."""
    out = _MATRIX[family]
    if dtype is not None:
        out = [s for s in out if s.dtype == dtype]
    return list(out)


# ---------------------------------------------------------------------------
# deterministic cases: the JAX package's numpy draws, in its order


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """fp32 numpy -> a tensor of ``dtype`` (rounded as ``jnp.astype``
    rounds: to nearest even) on ``device``."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype)).to(device)


def _segments_for(B: int, T: int, device):
    from tosem_tpu_torch.ops.flash_attention import SegmentIds
    # two segments a row plus a padded tail: the equal-id gate and the
    # padding semantics
    cut = T // 2
    pad = max(T // 8, 1)
    seg = np.ones((B, T), np.int32)
    seg[:, cut:] = 2
    seg[:, T - pad:] = 3
    t = torch.from_numpy(seg).to(device)
    return SegmentIds(q=t, kv=t)


def _flash_case(sc: Scenario, seed: int, device):
    from tosem_tpu_torch.ops.mask_programs import mask_from_spec
    p = sc.p()
    B, H, T, D = 1, 1, 128, 16
    rng = np.random.default_rng(seed)
    layout = p.get("layout", "bhtd")
    shape = (B, H, T, D) if layout == "bhtd" else (B, T, H, D)
    args = tuple(_tensor(rng.normal(size=shape), sc.dtype, device)
                 for _ in range(3))
    kwargs = {"layout": layout}
    if p.get("causal"):
        kwargs["causal"] = True
    if p.get("mask"):
        kwargs["mask"] = mask_from_spec(p["mask"], T)
    if p.get("segments"):
        kwargs["segment_ids"] = _segments_for(B, T, device)
    return args, kwargs


def _schedule_case(sc: Scenario, seed: int, device):
    from tosem_tpu_torch.ops.mask_programs import (CausalMask, LocalMask,
                                                   MultiHeadMask,
                                                   mask_from_spec)
    p = sc.p()
    B, H, T, D = 1, 2, 128, 16
    rng = np.random.default_rng(seed)
    args = tuple(_tensor(rng.normal(size=(B, H, T, D)), sc.dtype, device)
                 for _ in range(3))
    if p.get("multihead"):
        mask = MultiHeadMask((CausalMask(), LocalMask(32)))
    else:
        mask = mask_from_spec(p["mask"], T)
    kwargs = {"mask": mask}
    if p.get("segments"):
        kwargs["segment_ids"] = _segments_for(B, T, device)
    return args, kwargs


def _ints(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _paged_case(sc: Scenario, seed: int, device):
    p = sc.p()
    lens = p["lens"]
    B = len(lens)
    H, D, page, npg = 2, 16, 8, 4
    K = p.get("k", 0)
    rng = np.random.default_rng(seed)
    P = B * npg + 2
    kp = _tensor(rng.standard_normal((P, page, H, D)), sc.dtype, device)
    vp = _tensor(rng.standard_normal((P, page, H, D)), sc.dtype, device)
    bt = rng.permutation(P)[:B * npg].reshape(B, npg).astype(np.int32)
    sl = _ints(lens, device)
    qshape = (B, K, H, D) if K else (B, H, D)
    q = _tensor(rng.standard_normal(qshape), sc.dtype, device)
    kwargs = {}
    if p.get("window"):
        kwargs["window"] = p["window"]
    if p.get("q_rows"):
        kwargs["q_rows"] = _ints(p["q_rows"], device)
    if p.get("offsets"):
        # the rolling-table contract (window eviction): slot j holds
        # logical page po + j, po the first page still holding an
        # in-window key, through each sequence's last real page
        window = p["window"]
        kq = K or 1
        po = np.asarray(
            [max(int(n) - kq - window + 1, 0) // page for n in lens],
            np.int64)
        last = np.asarray(
            [(int(n) + page - 1) // page - 1 for n in lens], np.int64)
        w = int((last - po).max()) + 1
        po = np.minimum(po, npg - w)
        bt = np.stack([bt[b, int(po[b]):int(po[b]) + w] for b in range(B)])
        kwargs["page_offsets"] = _ints(po, device)
    return (q, kp, vp, _ints(bt, device), sl), kwargs


_BUILDERS = {"flash": _flash_case, "paged": _paged_case,
             "schedule": _schedule_case}


def build_case(sc: Scenario, seed: int = 0,
               device="cpu") -> Tuple[tuple, dict]:
    """Deterministic ``(args, kwargs)`` of the scenario on ``device``:
    the same values on every call and every device."""
    return _BUILDERS[sc.family](sc, seed, torch.device(device))


# ---------------------------------------------------------------------------
# oracles: brute-force numpy, sharing no code with either arm


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _dense_mask_oracle(q, k, v, kwargs) -> np.ndarray:
    """Numpy dense attention with the mask program and segments folded
    in: the oracle of the flash and schedule families."""
    from tosem_tpu_torch.ops.mask_programs import CausalMask
    layout = kwargs.get("layout", "bhtd")
    q, k, v = (_np(x) for x in (q, k, v))
    if layout == "bthd":
        q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    keep = np.ones((B, H, Tq, Tk), bool)
    mask = kwargs.get("mask")
    if kwargs.get("causal"):
        mask = CausalMask() if mask is None else (mask & CausalMask())
    if mask is not None:
        dm = np.asarray(mask.dense(Tq, Tk))
        keep &= (dm[None, None] if dm.ndim == 2 else dm[None])
    seg = kwargs.get("segment_ids")
    if seg is not None:
        sq = _np(seg.q)[:, :, None]
        sk = _np(seg.kv)[:, None, :]
        keep &= (sq == sk)[:, None]
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    s = np.where(keep, s, -1e30)
    s -= s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bhkd->bhqd", p, v)
    return out if layout == "bhtd" else out.transpose(0, 2, 1, 3)


def _paged_oracle(q, kp, vp, bt, sl, kwargs) -> np.ndarray:
    """Brute-force numpy decode oracle for every paged mode (multi-q
    intra-step causal bound, window, rolling offsets)."""
    q = _np(q)
    multi = q.ndim == 4
    q4 = q if multi else q[:, None]
    kp, vp = _np(kp), _np(vp)
    bt, sl = _np(bt).astype(np.int64), _np(sl).astype(np.int64)
    B, K, H, D = q4.shape
    page = kp.shape[1]
    T = bt.shape[1] * page
    window = kwargs.get("window")
    q_rows = kwargs.get("q_rows")
    po = kwargs.get("page_offsets")
    po = np.zeros(B, int) if po is None else _np(po).astype(np.int64)
    k = kp[bt].reshape(B, T, H, D)
    v = vp[bt].reshape(B, T, H, D)
    out = np.zeros((B, K, H, D), np.float32)
    for b in range(B):
        if sl[b] == 0:
            continue
        kr = K if q_rows is None else int(_np(q_rows)[b])
        for r in range(K):
            bound = int(sl[b]) - kr + min(r, kr - 1)
            lo = bound - window + 1 if window else 0
            idx = [t - po[b] * page for t in
                   range(max(lo, po[b] * page),
                         min(bound + 1, po[b] * page + T))]
            for h in range(H):
                s = q4[b, r, h] @ k[b, idx, h].T / np.sqrt(D)
                p = np.exp(s - s.max())
                p /= p.sum()
                out[b, r, h] = p @ v[b, idx, h]
    return out if multi else out[:, 0]


# ---------------------------------------------------------------------------
# the engine


def _platform(platform: Optional[str]) -> str:
    if platform is not None:
        return platform
    return "cuda" if torch.cuda.is_available() else "cpu"


def available_backends(family: str,
                       platform: Optional[str] = None) -> Tuple[str, ...]:
    """The family's arms this platform runs: ``cuda`` and ``torch`` (on
    CPU copies) where there is a card, ``torch`` alone on the CPU."""
    if family not in _MATRIX:
        raise ValueError(f"unknown parity family {family!r}; expected one "
                         f"of {FAMILIES}")
    if _platform(platform) == "cuda":
        return (registry.BACKEND_CUDA, registry.BACKEND_TORCH)
    return (registry.BACKEND_TORCH,)


def available_pairs(family: str, platform: Optional[str] = None
                    ) -> List[Tuple[str, str]]:
    """Every unordered pair of arms this platform runs."""
    names = available_backends(family, platform)
    return [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]


def _device_of(backend: str) -> str:
    return "cuda" if backend == registry.BACKEND_CUDA else "cpu"


def run_arm(family: str, backend: str, args: tuple,
            kwargs: dict) -> torch.Tensor:
    """One arm of a family on a built case, resolved strictly: the
    operands' platform must be the backend's."""
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    registry.resolve(family, backend, platform=registry.platform_of(args[0]),
                     dtype=registry.dtype_name(args[0].dtype))
    if family == "paged":
        return paged_attention(*args, backend=backend, **kwargs)
    return flash_attention(*args, backend=backend, **kwargs)


@functools.lru_cache(maxsize=512)
def _run_cell(family: str, backend: str, scenario: Scenario,
              seed: int) -> np.ndarray:
    """One arm over one scenario's case, on the arm's device; memoized
    (the cases are deterministic)."""
    args, kwargs = build_case(scenario, seed, _device_of(backend))
    with torch.no_grad():
        return _np(run_arm(family, backend, args, kwargs))


def reset_cell_cache() -> None:
    """Tests: drop memoized arm outputs."""
    _run_cell.cache_clear()


def check_pair(family: str, backend_a: str, backend_b: str,
               scenario: Scenario, *, seed: int = 0,
               atol: Optional[float] = None) -> float:
    """Run both arms over the scenario's case and hold them within the
    family's tolerance; returns the largest difference."""
    args, kwargs = build_case(scenario, seed)
    out_a = _run_cell(family, backend_a, scenario, seed)
    out_b = _run_cell(family, backend_b, scenario, seed)
    tol = atol if atol is not None else TOLERANCES[family][scenario.dtype]
    return _assert_close(out_a, out_b, tol, family, scenario,
                         f"{backend_a} vs {backend_b}", args, kwargs)


def check_oracle(family: str, backend: str, scenario: Scenario, *,
                 seed: int = 0, atol: Optional[float] = None) -> float:
    """Hold one arm to the family's numpy oracle."""
    args, kwargs = build_case(scenario, seed)
    out = _run_cell(family, backend, scenario, seed)
    if family == "paged":
        ref = _paged_oracle(*args, kwargs)
    else:
        ref = _dense_mask_oracle(args[0], args[1], args[2], kwargs)
    tol = atol if atol is not None else TOLERANCES[family][scenario.dtype]
    return _assert_close(out, ref, tol, family, scenario,
                         f"{backend} vs oracle", args, kwargs)


def _valid_rows_mask(family: str, args: tuple, kwargs: dict,
                     shape) -> np.ndarray:
    """The rows whose outputs are the contract: paged padding rows (r >=
    q_rows[b]) give discardable values, left out as serving drops
    them."""
    keep = np.ones(shape, bool)
    if family == "paged":
        q_rows = kwargs.get("q_rows")
        if q_rows is not None and len(shape) == 4:
            for b, kr in enumerate(_np(q_rows)):
                keep[b, int(kr):] = False
    return keep


def _assert_close(a: np.ndarray, b: np.ndarray, tol: float,
                  family: str, scenario: Scenario, who: str,
                  args: tuple, kwargs: dict) -> float:
    keep = _valid_rows_mask(family, args, kwargs, a.shape)
    if a.shape != b.shape:
        raise AssertionError(f"[parity:{scenario}] {who}: shapes "
                             f"{a.shape} != {b.shape}")
    if not np.isfinite(a[keep]).all() or not np.isfinite(b[keep]).all():
        raise AssertionError(
            f"[parity:{scenario}] {who}: non-finite outputs")
    diff = np.abs(np.where(keep, a, 0.0) - np.where(keep, b, 0.0))
    worst = float(diff.max()) if diff.size else 0.0
    if worst > tol:
        idx = np.unravel_index(int(diff.argmax()), diff.shape)
        raise AssertionError(
            f"[parity:{scenario}] {who}: max |diff| {worst:.3e} > "
            f"{tol:.0e} at {idx} (a={a[idx]:.6f}, b={b[idx]:.6f})")
    return worst


def run_matrix(families: Optional[Tuple[str, ...]] = None,
               platform: Optional[str] = None) -> List[dict]:
    """Every (family, pair, scenario) cell this platform runs: on the
    card each pair, on the CPU the ``torch`` arm against the oracles.
    One record a cell; raises on the first violation."""
    out: List[dict] = []
    for family in families or FAMILIES:
        pairs = available_pairs(family, platform)
        for sc in scenarios(family):
            if pairs:
                for a, b in pairs:
                    diff = check_pair(family, a, b, sc)
                    out.append({"family": family, "pair": (a, b),
                                "scenario": sc.name, "dtype": sc.dtype,
                                "max_abs_diff": diff})
            else:
                diff = check_oracle(family, registry.BACKEND_TORCH, sc)
                out.append({"family": family,
                            "pair": (registry.BACKEND_TORCH, "oracle"),
                            "scenario": sc.name, "dtype": sc.dtype,
                            "max_abs_diff": diff})
    return out
