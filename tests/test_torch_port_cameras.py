"""Port vs JAX on the camera models (ops/cameras.py) and the matrix form of
the projection (ops/projection.py), the same seeded numpy inputs on both
sides.

- camera_project for pinhole, OpenCV distortion, fisheye, f-theta (both
  reference polynomials) and ortho: atol 1e-4 px, rtol 1e-5;
- distort / undistort and the fisheye inversion: each against JAX (1e-6 /
  1e-5) and round trips (1e-4); f-theta's Newton inversion (1e-6);
- the rolling-shutter solve for the four scan orders: uv within 1e-4 px,
  validity equal; slerp and the shutter times;
- fully_fused_projection_ut (fisheye, OpenCV, f-theta, rolling shutter,
  and the UTParams knobs with compensations, radius_clip and eps2d):
  radii and depths equal (1e-5), and means2d and conics held to the JAX
  function's own f32 error. The UT mean weighs its 7 sigma points -99 and
  16.7 (alpha 0.1), so f32 rounding of the points shows ~1e-3 px in the
  mean on either side. The band is measured, not guessed: both the port
  and JAX in f32 are compared with the port in f64, and the port must lie
  no farther from it than 1.5x JAX's distance (+1e-5), and from JAX no
  farther than 2x it (+1e-5);
- a covariance whose Cholesky factor fails is culled as in JAX (NaN rows)
  and leaves a finite gradient;
- a point exactly on the optical axis (a splat's mean, the UT's first
  sigma point, can lie there): fisheye and f-theta pixels equal to JAX's,
  and a finite gradient where JAX's is NaN (sqrt(x^2 + y^2) at 0);
- image_point_to_world_ray for each model and under a rolling shutter
  (1e-5);
- world_to_cam, persp_proj, finish_projection and fully_fused_projection
  with matrix covariances and every knob against JAX (1e-4 px, conics
  rtol 1e-4, radii equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ftheta import FTHETA
from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.ops import cameras as jc
from hunyuanworld_mirror_tpu.ops import projection as jp
from hunyuanworld_mirror_tpu_torch.ops import cameras as pc
from hunyuanworld_mirror_tpu_torch.ops import projection as pp

W, H = 64, 48
K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)
K_FTHETA = np.array([[1.0, 0, 32.0], [0, 1.0, 24.0], [0, 0, 1]], np.float32)
RAD_CV = np.array([0.1, 0.02, 0.0, 0.01], np.float32)      # k1..k4 (rational)
TANG = np.array([0.01, -0.005], np.float32)
RAD_FE = np.array([0.05, -0.01, 0.002], np.float32)
P_FTHETA = pc.FThetaParams(*FTHETA)


def _pts(seed, n=200, spread=0.6, depth=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * spread + [0, 0, depth]).astype(np.float32)


def _pose_pair(dx=0.4, dyaw=0.08):
    vm0 = np.eye(4, dtype=np.float32)
    ca, sa = np.cos(dyaw), np.sin(dyaw)
    vm1 = np.array([[ca, 0, sa, dx], [0, 1, 0, 0], [-sa, 0, ca, 0], [0, 0, 0, 1]],
                   np.float32)
    return vm0, vm1


MODELS = {
    "pinhole": (jc.PINHOLE, {}, K),
    "opencv": (jc.PINHOLE, dict(radial=RAD_CV, tangential=TANG), K),
    "fisheye": (jc.FISHEYE, dict(radial=RAD_FE), K),
    "ftheta": (jc.FTHETA, dict(ftheta=True), K_FTHETA),
    "ftheta_bw": (jc.FTHETA, dict(ftheta="bw"), K_FTHETA),
    "ortho": (jc.ORTHO, {}, K),
}


def _model_kw(kw, side):
    """The coefficient keywords for one side ("j" JAX, "p" port)."""
    out = {}
    for k, v in kw.items():
        if k == "ftheta":
            fth = FTHETA if v is True else FTHETA._replace(reference_poly=jc.PIXELDIST_TO_ANGLE)
            out[k] = fth if side == "j" else pc.FThetaParams(*fth)
        else:
            out[k] = jnp.asarray(v) if side == "j" else t(v)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_camera_project_matches_jax(name):
    model, kw, Km = MODELS[name]
    pts = _pts(0)
    uv_j = jc.camera_project(jnp.asarray(pts), jnp.asarray(Km), model, **_model_kw(kw, "j"))
    uv_p = pc.camera_project(t(pts), t(Km), model, **_model_kw(kw, "p"))
    assert np.isfinite(np_(uv_p)).all()
    close(uv_p, uv_j, 1e-4, rtol=1e-5)


def test_distortion_round_trips():
    xy = np.random.default_rng(1).uniform(-0.4, 0.4, size=(300, 2)).astype(np.float32)
    xd_j = jc.distort_opencv(jnp.asarray(xy), jnp.asarray(RAD_CV), jnp.asarray(TANG))
    xd_p = pc.distort_opencv(t(xy), t(RAD_CV), t(TANG))
    close(xd_p, xd_j, 1e-6)
    xu_j = jc.undistort_opencv(xd_j, jnp.asarray(RAD_CV), jnp.asarray(TANG))
    xu_p = pc.undistort_opencv(xd_p, t(RAD_CV), t(TANG))
    close(xu_p, xu_j, 1e-5)
    close(xu_p, xy, 1e-4)                              # distort then undistort
    # the fisheye radius theta (1 + k1 th^2 + ...) inverted by 10 Newton steps
    theta = np.linspace(0.0, 1.2, 97, dtype=np.float32)
    th2 = theta * theta
    rd = theta * (1 + RAD_FE[0] * th2 + RAD_FE[1] * th2 ** 2 + RAD_FE[2] * th2 ** 3)
    inv_j = jc._invert_fisheye_theta(jnp.asarray(rd), jnp.asarray(RAD_FE))
    inv_p = pc._invert_fisheye_theta(t(rd), t(RAD_FE))
    close(inv_p, inv_j, 1e-5)
    close(inv_p, theta, 1e-4)
    assert pc._invert_fisheye_theta(t(rd), None) is not None
    # f-theta: Newton on the forward polynomial, 3 steps
    th = np.linspace(0.01, 0.8, 64, dtype=np.float32)
    delta = np.asarray(jc._horner(FTHETA.angle_to_pixeldist_poly, jnp.asarray(th)))
    close(pc._horner(FTHETA.angle_to_pixeldist_poly, t(th)), delta, 1e-5)
    close(pc._newton_invert_poly(FTHETA.angle_to_pixeldist_poly,
                                 FTHETA.pixeldist_to_angle_poly, t(delta)),
          jc._newton_invert_poly(FTHETA.angle_to_pixeldist_poly,
                                 FTHETA.pixeldist_to_angle_poly, jnp.asarray(delta)), 1e-6)


@pytest.mark.parametrize("shutter", [jc.SHUTTER_TOP_TO_BOTTOM, jc.SHUTTER_LEFT_TO_RIGHT,
                                     jc.SHUTTER_BOTTOM_TO_TOP, jc.SHUTTER_RIGHT_TO_LEFT])
def test_shutter_solve_matches_jax(shutter):
    vm0, vm1 = _pose_pair()
    pts = _pts(2)
    q0j, t0j = jc._viewmat_pose(jnp.asarray(vm0))
    q1j, t1j = jc._viewmat_pose(jnp.asarray(vm1))
    q0p, t0p = pc._viewmat_pose(t(vm0))
    q1p, t1p = pc._viewmat_pose(t(vm1))
    close(q1p, q1j, 1e-6)
    uv_j, v_j = jax.jit(lambda p: jc.world_point_to_image_shutter(
        p, jnp.asarray(K), (q0j, t0j), (q1j, t1j), W, H, shutter))(jnp.asarray(pts))
    uv_p, v_p = pc.world_point_to_image_shutter(t(pts), t(K), (q0p, t0p), (q1p, t1p),
                                                W, H, shutter)
    close(uv_p, uv_j, 1e-4)
    np.testing.assert_array_equal(np_(v_p), np.asarray(v_j))
    tr = np.random.default_rng(3).uniform(size=(50,)).astype(np.float32)
    close(pc._quat_slerp(q0p, q1p, t(tr)), jc._quat_slerp(q0j, q1j, jnp.asarray(tr)), 1e-6)
    close(pc.shutter_relative_time(uv_p, W, H, shutter),
          jc.shutter_relative_time(jnp.asarray(np_(uv_p)), W, H, shutter), 1e-7)


def _ut_inputs(seed=4, n=300):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) + [0, 0, 4.0]).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = rng.uniform(0.02, 0.2, size=(n, 3)).astype(np.float32)
    return means, q, s


UT_CASES = {
    "fisheye": dict(camera_model=jc.FISHEYE, radial_coeffs=np.stack([RAD_FE, RAD_FE])),
    "opencv": dict(radial_coeffs=np.stack([RAD_CV, RAD_CV]),
                   tangential_coeffs=np.stack([TANG, TANG])),
    "ftheta": dict(camera_model=jc.FTHETA, ftheta_coeffs=True),
    "rolling_shutter": dict(rolling_shutter=jc.SHUTTER_TOP_TO_BOTTOM, viewmats_rs=True),
    "knobs": dict(rolling_shutter=jc.SHUTTER_LEFT_TO_RIGHT, viewmats_rs=True,
                  ut_params=(0.5, 2.0, 0.0, 0.0, False), calc_compensations=True,
                  radius_clip=2.0, eps2d=0.1, near_plane=2.5),
}


def _ut_kw(kw, side, vms_rs, dtype=torch.float32):
    out = {}
    for k, v in kw.items():
        if k == "ftheta_coeffs":
            out[k] = FTHETA if side == "j" else P_FTHETA
        elif k == "viewmats_rs":
            out[k] = jnp.asarray(vms_rs) if side == "j" else t(vms_rs).to(dtype)
        elif k == "ut_params":
            out[k] = (jc.UTParams if side == "j" else pc.UTParams)(*v)
        elif isinstance(v, np.ndarray):
            out[k] = jnp.asarray(v) if side == "j" else t(v).to(dtype)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("case", list(UT_CASES))
def test_ut_projection_matches_jax(case):
    kw = UT_CASES[case]
    means, q, s = _ut_inputs()
    vm0, vm1 = _pose_pair()
    vms, vms_rs = np.stack([vm0, vm1]), np.stack([vm1, vm0])
    Km = K_FTHETA if case == "ftheta" else K
    Ks = np.stack([Km, Km])
    jkw = _ut_kw(kw, "j", vms_rs)
    a = jax.jit(lambda m, q_, s_, v, k: jc.fully_fused_projection_ut(
        m, jp.quat_scale_to_covar(q_, s_), v, k, W, H, **jkw))(
        *(jnp.asarray(x) for x in (means, q, s, vms, Ks)))
    b = pc.fully_fused_projection_ut(t(means), pp.quat_scale_to_covar(t(q), t(s)),
                                     t(vms), t(Ks), W, H, **_ut_kw(kw, "p", vms_rs))
    d64 = torch.float64
    c = pc.fully_fused_projection_ut(
        t(means).to(d64), pp.quat_scale_to_covar(t(q).to(d64), t(s).to(d64)),
        t(vms).to(d64), t(Ks).to(d64), W, H, **_ut_kw(kw, "p", vms_rs, d64))
    np.testing.assert_array_equal(np_(b.radii), np.asarray(a.radii))
    close(b.depths, a.depths, 1e-5)
    live = (np.asarray(a.radii) > 0).all(-1)
    assert live.sum() > 100
    if kw.get("calc_compensations"):
        close(np_(b.compensations)[live], np.asarray(a.compensations)[live], 1e-4)
    for name in ("means2d", "conics"):
        jx, po = np.asarray(getattr(a, name))[live], np_(getattr(b, name))[live]
        ref = getattr(c, name).numpy()[live]
        err_j = np.abs(jx - ref).max()
        assert np.abs(po - ref).max() <= 1.5 * err_j + 1e-5, (name, err_j)
        assert np.abs(po - jx).max() <= 2.0 * err_j + 1e-5, (name, err_j)


def test_ut_cholesky_failure_is_culled_with_finite_grad():
    means, q, s = _ut_inputs(5, n=20)
    cov = np.array(jp.quat_scale_to_covar(jnp.asarray(q), jnp.asarray(s)))
    cov[3] = -cov[3]                                     # no Cholesky factor
    vm = np.eye(4, dtype=np.float32)[None]
    a = jax.jit(lambda m, cv: jc.fully_fused_projection_ut(
        m, cv, jnp.asarray(vm), jnp.asarray(K[None]), W, H, camera_model=jc.FISHEYE))(
        jnp.asarray(means), jnp.asarray(cov))
    m = t(means).requires_grad_(True)
    cv = t(cov).requires_grad_(True)
    b = pc.fully_fused_projection_ut(m, cv, t(vm), t(K[None]), W, H,
                                     camera_model=jc.FISHEYE)
    np.testing.assert_array_equal(np_(b.radii), np.asarray(a.radii))
    assert int(b.radii[0, 3].abs().sum()) == 0 and bool(torch.isnan(b.means2d[0, 3]).all())
    keep = (b.radii[0] > 0).all(-1)
    (b.means2d[0][keep].sum() + b.conics[0][keep].sum()).backward()
    assert torch.isfinite(m.grad).all() and torch.isfinite(cv.grad).all()
    assert float(cv.grad[3].abs().sum()) == 0.0


@pytest.mark.parametrize("name", ["fisheye", "ftheta"])
def test_on_axis_gradient_is_finite(name):
    model, kw, Km = MODELS[name]
    pts = np.array([[0.0, 0.0, 2.0], [0.1, -0.2, 3.0]], np.float32)

    def jloss(p):
        return jnp.sum(jc.camera_project(p, jnp.asarray(Km), model, **_model_kw(kw, "j")))

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(pts)))
    assert np.isnan(g_j[0]).any() and np.isfinite(g_j[1]).all()
    p = t(pts).requires_grad_(True)
    uv = pc.camera_project(p, t(Km), model, **_model_kw(kw, "p"))
    close(uv, jc.camera_project(jnp.asarray(pts), jnp.asarray(Km), model,
                                **_model_kw(kw, "j")), 1e-4, rtol=1e-5)
    uv.sum().backward()
    assert torch.isfinite(p.grad).all()
    close(p.grad[1], g_j[1], 1e-3, rtol=1e-4)


RAY_CASES = {
    "pinhole": (jc.PINHOLE, {}, K),
    "opencv": (jc.PINHOLE, dict(radial=RAD_CV, tangential=TANG), K),
    "fisheye": (jc.FISHEYE, dict(radial=RAD_FE), K),
    "ftheta": (jc.FTHETA, dict(ftheta=True), K_FTHETA),
    "ftheta_bw": (jc.FTHETA, dict(ftheta="bw"), K_FTHETA),
    "rolling_shutter": (jc.PINHOLE, dict(rs=True), K),
}


@pytest.mark.parametrize("name", list(RAY_CASES))
def test_world_rays_match_jax(name):
    model, kw, Km = RAY_CASES[name]
    vm0, vm1 = _pose_pair()
    vm0[:3, 3] = [0.1, -0.2, 0.3]
    px = np.random.default_rng(6).uniform([0, 0], [W, H], size=(128, 2)).astype(np.float32)
    extra_j, extra_p = {}, {}
    if kw.get("rs"):
        kw = {}
        extra_j = dict(rolling_shutter=jc.SHUTTER_TOP_TO_BOTTOM,
                       viewmat_rs=jnp.asarray(vm1), width=W, height=H)
        extra_p = dict(rolling_shutter=jc.SHUTTER_TOP_TO_BOTTOM, viewmat_rs=t(vm1),
                       width=W, height=H)
    o_j, d_j = jc.image_point_to_world_ray(jnp.asarray(px), jnp.asarray(vm0),
                                           jnp.asarray(Km), model,
                                           **_model_kw(kw, "j"), **extra_j)
    o_p, d_p = pc.image_point_to_world_ray(t(px), t(vm0), t(Km), model,
                                           **_model_kw(kw, "p"), **extra_p)
    assert o_p.shape == o_j.shape and d_p.shape == d_j.shape
    close(o_p, o_j, 1e-5)
    close(d_p, d_j, 1e-5)
    close(torch.linalg.norm(d_p, dim=-1), np.ones(len(px)), 1e-5)


def test_projection_matrix_form_matches_jax():
    means, q, s = _ut_inputs(7)
    vm0, vm1 = _pose_pair()
    vms, Ks = np.stack([vm0, vm1]), np.stack([K, K])
    cov_j = jp.quat_scale_to_covar(jnp.asarray(q), jnp.asarray(s))
    cov_p = pp.quat_scale_to_covar(t(q), t(s))
    mc_j, cc_j = jp.world_to_cam(jnp.asarray(means), cov_j, jnp.asarray(vms))
    mc_p, cc_p = pp.world_to_cam(t(means), cov_p, t(vms))
    close(mc_p, mc_j, 1e-5)
    close(cc_p, cc_j, 1e-7)
    m2_j, c2_j = jp.persp_proj(mc_j, cc_j, jnp.asarray(Ks), W, H)
    m2_p, c2_p = pp.persp_proj(mc_p, cc_p, t(Ks), W, H)
    close(m2_p, m2_j, 1e-4, rtol=1e-5)
    close(c2_p, c2_j, 1e-4, rtol=1e-4)
    extra = np.random.default_rng(8).uniform(size=(2, len(means))) > 0.3
    kw = dict(eps2d=0.2, near_plane=3.0, far_plane=6.0, calc_compensations=True,
              radius_clip=1.5)
    f_j = jp.finish_projection(m2_j, c2_j, mc_j[..., 2], W, H, extra_valid=jnp.asarray(extra),
                               **kw)
    f_p = pp.finish_projection(m2_p, c2_p, mc_p[..., 2], W, H, extra_valid=torch.tensor(extra),
                               **kw)
    np.testing.assert_array_equal(np_(f_p.radii), np.asarray(f_j.radii))
    close(f_p.conics, f_j.conics, 1e-5, rtol=1e-4)
    close(f_p.compensations, f_j.compensations, 1e-6)
    # the plane route with matrix covariances and every knob
    for cov in (cov_p, pp.quat_scale_to_covar_planes(t(q), t(s))):
        ffp = pp.fully_fused_projection(t(means), cov, t(vms), t(Ks), W, H, **kw)
        ffj = jp.fully_fused_projection(jnp.asarray(means), cov_j, jnp.asarray(vms),
                                        jnp.asarray(Ks), W, H, **kw)
        np.testing.assert_array_equal(np_(ffp.radii), np.asarray(ffj.radii))
        close(ffp.means2d, ffj.means2d, 1e-4, rtol=1e-5)
        close(ffp.conics, ffj.conics, 1e-5, rtol=1e-4)
        close(ffp.compensations, ffj.compensations, 1e-6)
        assert int((np_(ffp.radii) > 0).all(-1).sum()) > 50
