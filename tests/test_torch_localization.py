"""Localization-lite (``models/localization.py``): EKF fusion + RTK
interpolation, held to the JAX package's own tests and to the JAX
package.

Copies of ``tests/test_localization.py``'s eight tests against the port
on the CPU (the fleet is the EKF's leading axis, where the JAX package
vmaps), the step-by-step numpy oracle included. Across packages, on the
same simulated IMU and GNSS streams: ``ekf_localize``'s states and
covariances, ``dead_reckon`` and ``rtk_interpolate`` within ``LOC_TOL``
of the largest value (fp32 4 x 4 products and a 2 x 2 inverse in
another order), and the component's pose stream.
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.dataflow.components import Component, ComponentRuntime
from tosem_tpu_torch.models.localization import (EkfParams,
                                                 LocalizationComponent,
                                                 dead_reckon, ekf_localize,
                                                 rtk_interpolate)

torch.set_num_threads(1)
CPU = "cpu"
LOC_TOL = 1e-5


def _x0(v):
    x0 = torch.zeros(4)
    x0[3] = v
    return x0


def _simulate(T=400, dt=0.01, seed=0, yaw_rate=0.2, accel=0.5,
              imu_noise=(0.02, 0.1), gnss_noise=0.3, fix_every=25,
              gyro_bias=0.0):
    """Ground-truth unicycle trajectory + noisy IMU/GNSS observations.

    ``gyro_bias`` models the constant rate offset real IMUs carry — the
    reason dead reckoning diverges and fusion exists.
    """
    rng = np.random.default_rng(seed)
    x = np.zeros(4, np.float64)
    x[3] = 5.0
    truth, imu, gnss, mask = [], [], [], []
    for t in range(T):
        w = yaw_rate * np.sin(t * dt)          # weaving
        a = accel * np.cos(t * dt * 0.5)
        x = np.array([x[0] + x[3] * np.cos(x[2]) * dt,
                      x[1] + x[3] * np.sin(x[2]) * dt,
                      x[2] + w * dt,
                      x[3] + a * dt])
        truth.append(x)
        imu.append([w + gyro_bias + rng.normal(0, imu_noise[0]),
                    a + rng.normal(0, imu_noise[1])])
        has_fix = (t % fix_every) == fix_every - 1
        mask.append(1.0 if has_fix else 0.0)
        gnss.append(x[:2] + rng.normal(0, gnss_noise, 2)
                    if has_fix else np.zeros(2))
    return (np.array(truth), np.array(imu, np.float32),
            np.array(gnss, np.float32), np.array(mask, np.float32))


def _numpy_ekf(x0, imu, gnss, mask, p: EkfParams):
    """Branching (if fix: update) reference filter — the oracle."""
    x = np.asarray(x0, np.float64)
    cov = np.eye(4) * p.p0
    q = np.diag([p.q_pos, p.q_pos, p.q_yaw, p.q_v])
    r = np.eye(2) * p.r_gnss
    h = np.zeros((2, 4)); h[0, 0] = h[1, 1] = 1.0
    out = []
    for t in range(len(imu)):
        w, a = imu[t]
        px, py, yaw, v = x
        x = np.array([px + v * np.cos(yaw) * p.dt,
                      py + v * np.sin(yaw) * p.dt,
                      yaw + w * p.dt, v + a * p.dt])
        f = np.eye(4)
        f[0, 2] = -v * np.sin(yaw) * p.dt
        f[0, 3] = np.cos(yaw) * p.dt
        f[1, 2] = v * np.cos(yaw) * p.dt
        f[1, 3] = np.sin(yaw) * p.dt
        cov = f @ cov @ f.T + q
        if mask[t] > 0:
            s = h @ cov @ h.T + r
            k = cov @ h.T @ np.linalg.inv(s)
            x = x + k @ (gnss[t] - h @ x)
            cov = (np.eye(4) - k @ h) @ cov
        out.append(x)
    return np.array(out)


class TestEkf:
    def test_masked_scan_matches_branching_oracle(self):
        truth, imu, gnss, mask = _simulate(T=200)
        p = EkfParams()
        xs, _ = ekf_localize(_x0(5.0), imu, gnss, mask, p)
        want = _numpy_ekf(np.array([0, 0, 0, 5.0]), imu, gnss, mask, p)
        np.testing.assert_allclose(xs.numpy(), want, atol=2e-3)

    def test_fusion_beats_dead_reckoning(self):
        truth, imu, gnss, mask = _simulate(T=800, seed=3,
                                           gyro_bias=0.05)
        x0 = _x0(5.0)
        fused, _ = ekf_localize(x0, imu, gnss, mask)
        dr = dead_reckon(x0, imu)
        err_f = np.linalg.norm(fused.numpy()[:, :2] - truth[:, :2],
                               axis=1)
        err_d = np.linalg.norm(dr.numpy()[:, :2] - truth[:, :2],
                               axis=1)
        # second half (after convergence): fused stays bounded, DR drifts
        assert err_f[400:].mean() < 0.5
        assert err_f[400:].mean() < 0.5 * err_d[400:].mean()

    def test_covariance_contracts_on_fix(self):
        _, imu, gnss, mask = _simulate(T=100, fix_every=50)
        xs, ps = ekf_localize(_x0(5.0), imu, gnss, mask)
        ps = ps.numpy()
        fix_idx = int(np.nonzero(np.asarray(mask))[0][0])
        assert ps[fix_idx, 0, 0] < ps[fix_idx - 1, 0, 0]

    def test_vmap_fleet_matches_single(self):
        _, imu, gnss, mask = _simulate(T=150)
        x0s = torch.stack([_x0(5.0), _x0(3.0)])
        batched, _ = ekf_localize(x0s, imu, gnss, mask)   # a fleet
        single0, _ = ekf_localize(x0s[0], imu, gnss, mask)
        single1, _ = ekf_localize(x0s[1], imu, gnss, mask)
        np.testing.assert_allclose(batched[0].numpy(), single0.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(batched[1].numpy(), single1.numpy(),
                                   atol=1e-5)


class TestRtkInterpolate:
    def test_linear_motion_is_exact(self):
        t = torch.arange(10.0)
        pose = torch.stack([2.0 * t, -1.0 * t], 1)     # linear in t
        q = torch.tensor([0.5, 3.25, 8.75])
        got = rtk_interpolate(t, pose, q)
        np.testing.assert_allclose(
            got.numpy(), np.stack([2.0 * q.numpy(), -1.0 * q.numpy()], 1),
            atol=1e-5)

    def test_out_of_range_clamps(self):
        t = torch.tensor([1.0, 2.0, 3.0])
        pose = torch.tensor([[10.0], [20.0], [30.0]])
        got = rtk_interpolate(t, pose, torch.tensor([0.0, 99.0]))
        np.testing.assert_allclose(got.numpy(), [[10.0], [30.0]])


class TestDrivingPipelineIntegration:
    def test_localize_branch_mounts_and_publishes(self):
        from tosem_tpu_torch.models.control import build_driving_pipeline
        rtc = ComponentRuntime()
        comps = build_driving_pipeline(rtc, frame_dt=0.1, localize=True,
                                       device=CPU)
        assert len(comps) == 5
        poses: list = []

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["pose"])

            def proc(self, pose, *fused):
                poses.append(pose)

        rtc.add(Sink())
        imu_w = rtc.writer("imu")
        gnss_w = rtc.writer("gnss")
        gnss_w({"pos": [0.8, 0.0]})
        imu_w({"yaw_rate": 0.0, "accel": 0.0})
        rtc.run_until(1.0)
        assert len(poses) == 1 and poses[0]["v"] > 0


class TestComponent:
    def test_pose_stream_converges_to_fixes(self):
        rtc = ComponentRuntime()
        rtc.add(LocalizationComponent(
            x0=(0.0, 0.0, 0.0, 5.0),
            params=EkfParams(dt=0.1, r_gnss=0.05), device=CPU))
        poses: list = []

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["pose"])

            def proc(self, pose, *fused):
                poses.append(pose)

        rtc.add(Sink())
        imu_w = rtc.writer("imu")
        gnss_w = rtc.writer("gnss")
        # straight line at 5 m/s with fixes reporting a parallel lane
        # offset (y=1): the filter must pull toward the fixes
        for i in range(30):
            if i % 5 == 4:
                gnss_w({"pos": [0.5 * (i + 1), 1.0]})
            imu_w({"yaw_rate": 0.0, "accel": 0.0})
            rtc.run_until(float(i + 1))

        assert len(poses) == 30
        assert poses[-1]["pos"][1] == pytest.approx(1.0, abs=0.3)
        # covariance shrinks vs its prior once fixes are absorbed
        assert poses[-1]["cov"][0] < poses[0]["cov"][0]
        # each fix is consumed at most once (masked steps in between)
        assert poses[-1]["v"] == pytest.approx(5.0, abs=0.5)


# ------------------------------------------------- against the JAX package

def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("seed,fix_every,bias", [(0, 25, 0.0), (3, 10, 0.05),
                                                 (5, 50, 0.02)])
def test_ekf_matches_the_jax_package(seed, fix_every, bias):
    import jax.numpy as jnp
    from tosem_tpu.models import localization as ref
    _, imu, gnss, mask = _simulate(T=300, seed=seed, fix_every=fix_every,
                                   gyro_bias=bias)
    x0 = np.array([0.0, 0.0, 0.0, 5.0], np.float32)
    p = EkfParams(dt=0.01)
    want_x, want_p = ref.ekf_localize(jnp.asarray(x0), imu, gnss, mask,
                                      ref.EkfParams(dt=0.01))
    got_x, got_p = ekf_localize(x0, imu, gnss, mask, p, device=CPU)
    assert _rel(got_x, want_x) <= LOC_TOL
    assert _rel(got_p, want_p) <= LOC_TOL
    dr_want = ref.dead_reckon(jnp.asarray(x0), imu)
    assert _rel(dead_reckon(x0, imu, device=CPU), dr_want) <= LOC_TOL


@pytest.mark.parametrize("seed", range(3))
def test_rtk_interpolate_matches_the_jax_package(seed):
    import jax.numpy as jnp
    from tosem_tpu.models import localization as ref
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.005, 0.02, 200)).astype(np.float32)
    pose = np.cumsum(rng.normal(0, 1, (200, 3)), 0).astype(np.float32)
    fix = rng.uniform(t[0] - 0.5, t[-1] + 0.5, 40).astype(np.float32)
    want = ref.rtk_interpolate(jnp.asarray(t), jnp.asarray(pose),
                               jnp.asarray(fix))
    assert _rel(rtk_interpolate(t, pose, fix, device=CPU), want) <= LOC_TOL


def test_component_pose_stream_matches_the_jax_package():
    from tosem_tpu.dataflow.components import Component as RefComponent
    from tosem_tpu.dataflow.components import ComponentRuntime as RefRt
    from tosem_tpu.models import localization as ref

    def run(rt_cls, comp_cls, make):
        rtc, poses = rt_cls(), []

        class Sink(comp_cls):
            def __init__(self):
                super().__init__("sink", ["pose"])

            def proc(self, pose, *fused):
                poses.append(pose)
        rtc.add(make())
        rtc.add(Sink())
        imu_w, gnss_w = rtc.writer("imu"), rtc.writer("gnss")
        rng = np.random.default_rng(9)
        for i in range(40):
            if i % 5 == 4:
                gnss_w({"pos": [0.5 * (i + 1) + rng.normal(0, 0.3),
                                1.0 + rng.normal(0, 0.3)]})
            imu_w({"yaw_rate": float(rng.normal(0, 0.05)),
                   "accel": float(rng.normal(0, 0.2))})
            rtc.run_until(float(i + 1))
        return poses
    kw = {"x0": (0.0, 0.0, 0.0, 5.0)}
    want = run(RefRt, RefComponent, lambda: ref.LocalizationComponent(
        params=ref.EkfParams(dt=0.1, r_gnss=0.05), **kw))
    got = run(ComponentRuntime, Component, lambda: LocalizationComponent(
        params=EkfParams(dt=0.1, r_gnss=0.05), device=CPU, **kw))
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert _rel(np.r_[g["pos"], g["yaw"], g["v"]],
                    np.r_[w["pos"], w["yaw"], w["v"]]) <= LOC_TOL
        assert _rel(g["cov"], w["cov"]) <= LOC_TOL
