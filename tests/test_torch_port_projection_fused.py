"""Kernel K6's route, the pinhole projection from the splat parameters to
the blend's inputs (ops/projection.py project_pinhole), on the CPU, where
it runs K6's plain versions:
- the analytic VJP (project_bwd_plain) against autograd of the plain
  forward and against jax.vjp of the JAX package's fully_fused_projection
  with its SH colours, at f32 1e-5 relative, over the render modes, SH
  degrees 0-3 and direct colours, compensations, radius_clip, loose radii
  and both quaternion orders;
- dead slots at the origin, on a camera's focal plane (0 / 0): culled, the
  live rows' gradients finite and equal to the plain path's;
- the wrappers run the plain versions on a CPU tensor, launch nothing,
  refuse any other device but CUDA, and hand the C entries their
  arguments as the signatures say;
- rasterize's dispatch: pinhole cameras that take no gradient take the
  route (counted once a camera in profiling's "project_fused"), the UT
  cameras and cameras with a gradient (pose optimisation) keep the plain
  projection under autograd, and both give the same render and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import _random_scene
from torch_port_helpers import close, t
from hunyuanworld_mirror_tpu.ops import projection as jproj
from hunyuanworld_mirror_tpu.utils import sh as jsh
from hunyuanworld_mirror_tpu_torch.ops import projection as P
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.utils import profiling as pprof

W, H = 64, 48
REL = 1e-5
NAMES = ("means", "quats", "scales", "opacities", "colors")
COLOURS = ("direct", 0, 1, 2, 3)          # direct RGB, or SH of that degree
# (calc_compensations, radius_clip, tight_radius, quat_order)
KNOBS = [(False, 0.0, True, "wxyz"), (True, 0.0, True, "xyzw"),
         (False, 1.5, True, "xyzw"), (True, 2.0, False, "wxyz")]


def _scene(colours, seed=3, n=150):
    """One camera's scene: means, quats, scales, opacities, colours (direct
    (N, 3) or SH (N, K, 3)), viewmat, K (a skew term)."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(seed), n=n, c=2)
    if colours != "direct":
        colors = (np.random.default_rng(seed + 1).normal(
            size=(n, (colours + 1) ** 2, 3)) * 0.4).astype(np.float32)
    Ks[1, 0, 1] = 0.7
    return [t(a) for a in (means, quats, scales, opac, colors)], t(viewmats[1]), t(Ks[1])


def _cotangents(outs, cam, seed=1):
    g = torch.Generator().manual_seed(seed)
    v = [torch.randn(outs[i].shape, generator=g) for i in (0, 1, 2, 3, 5)]
    if not cam.calc_compensations:
        v[3] = None
    return v


def _autograd(ins, viewmat, K, cam, v):
    leaves = [x.clone().requires_grad_(True) for x in ins]
    outs = P.project_fwd_plain(*leaves, viewmat, K, cam)
    pairs = [(outs[i], v[j]) for j, i in enumerate((0, 1, 2, 3, 5)) if v[j] is not None]
    grads = torch.autograd.grad(sum((o * g).sum() for o, g in pairs), leaves,
                                allow_unused=True)
    return list(grads)


def _close_rel(got, ref, name):
    scale = float(np.abs(np.asarray(ref)).max())
    close(got, ref, REL * scale, err_msg=name)


def _check_against(got, refs):
    """got and refs by parameter; None stands for a zero gradient."""
    for name, a, r in zip(NAMES, got, refs):
        if a is None or r is None:
            assert not np.any(np.asarray(a if r is None else r)), name
            continue
        assert a is not None and torch.isfinite(a).all(), name
        _close_rel(a, r, name)


# every render mode and colour kind, the knobs cycling through KNOBS
CASES = [(mode, colours, KNOBS[(i + j) % len(KNOBS)])
         for i, mode in enumerate(P.RENDER_MODES) for j, colours in enumerate(COLOURS)]


@pytest.mark.parametrize("mode,colours,knobs", CASES)
def test_vjp_matches_autograd(mode, colours, knobs):
    comp, clip, tight, order = knobs
    ins, vm, K = _scene(colours)
    cam = P.Pinhole(W, H, mode, calc_compensations=comp, radius_clip=clip,
                    tight_radius=tight, quat_order=order)
    v = _cotangents(P.project_fwd_plain(*ins, vm, K, cam), cam)
    ref = _autograd(ins, vm, K, cam, v)
    got = list(P.project_bwd_plain(*ins, vm, K, cam, *v))
    if not comp:
        # the opacities pass the projection unchanged: their cotangent is
        # the rasterizer's, which ProjectPinhole does not see
        assert got[3] is None
        got[3] = ref[3] = None
    _check_against(got, ref)


@pytest.mark.parametrize("knobs", KNOBS)
def test_vjp_matches_autograd_knobs(knobs):
    """Each knob set in RGB+ED with SH degree 3."""
    comp, clip, tight, order = knobs
    ins, vm, K = _scene(3, seed=7)
    cam = P.Pinhole(W, H, "RGB+ED", calc_compensations=comp, radius_clip=clip,
                    tight_radius=tight, quat_order=order)
    v = _cotangents(P.project_fwd_plain(*ins, vm, K, cam), cam)
    ref = _autograd(ins, vm, K, cam, v)
    got = list(P.project_bwd_plain(*ins, vm, K, cam, *v))
    if not comp:
        got[3] = ref[3] = None
    _check_against(got, ref)


def _jax_outputs(means, quats, scales, opac, colors, viewmat, K, cam):
    """The JAX package's projection of one camera with its SH colours and
    the render mode's channels, as its rasterize composes them per camera."""
    q = jnp.concatenate([quats[..., 1:], quats[..., :1]], -1) \
        if cam.quat_order == "wxyz" else quats
    cov = jproj.quat_scale_to_covar_planes(q, scales)
    proj = jproj.fully_fused_projection(
        means, cov, viewmat[None], K[None], W, H, eps2d=cam.eps2d,
        near_plane=cam.near_plane, far_plane=cam.far_plane,
        calc_compensations=cam.calc_compensations, radius_clip=cam.radius_clip)
    dep = proj.depths[0]
    op = opac * proj.compensations[0] if cam.calc_compensations else opac
    if colors.ndim == 2:
        col = colors
    else:
        cam_t = -jnp.einsum("ij,i->j", viewmat[:3, :3], viewmat[:3, 3],
                            precision="highest")
        dirs = means - cam_t[None, :]
        dirs = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-8)
        deg = int(colors.shape[-2] ** 0.5) - 1
        col = jnp.clip(jsh.eval_sh(deg, jnp.swapaxes(colors, -1, -2), dirs) + 0.5, 0.0, None)
    if cam.render_mode in ("D", "ED"):
        col = dep[..., None]
    elif cam.render_mode in ("RGB+D", "RGB+ED"):
        col = jnp.concatenate([col, dep[..., None]], -1)
    return proj.means2d[0], proj.conics[0], col, op, dep


@pytest.mark.parametrize("mode,colours,knobs", CASES)
def test_vjp_matches_jax(mode, colours, knobs):
    """project_bwd_plain against jax.vjp of the JAX package's projection and
    SH."""
    comp, clip, tight, order = knobs
    ins, vm, K = _scene(colours, seed=11)
    cam = P.Pinhole(W, H, mode, calc_compensations=comp, radius_clip=clip,
                    tight_radius=tight, quat_order=order)
    v = _cotangents(P.project_fwd_plain(*ins, vm, K, cam), cam)
    v_jax = [jnp.zeros(ins[3].shape) if x is None else jnp.asarray(x.numpy())
             for x in v]
    _, vjp = jax.vjp(lambda *a: _jax_outputs(*a, jnp.asarray(vm.numpy()),
                                             jnp.asarray(K.numpy()), cam),
                     *(jnp.asarray(x.numpy()) for x in ins))
    ref = list(vjp(tuple(v_jax)))
    got = list(P.project_bwd_plain(*ins, vm, K, cam, *v))
    if not comp:
        got[3] = ref[3] = None
    _check_against(got, ref)


def _dead_scene(n_dead=40):
    """A scene with dead slots as the refine step pads them (the origin,
    identity quats, opacity 0) and camera 0 at the origin: they are 0 / 0
    on its focal plane."""
    (means, quats, scales, opac, colors), _, _ = _scene(0, seed=5)
    pad = lambda x, v: torch.cat([x, torch.full((n_dead,) + x.shape[1:], v)])
    quats = pad(quats, 0.0)
    quats[-n_dead:, 0] = 1.0
    ins = [pad(means, 0.0), quats, pad(scales, 1e-3), pad(opac, 0.0), pad(colors, 0.1)]
    _, _, _, _, _, viewmats, Ks = _random_scene(np.random.default_rng(5), n=1, c=2)
    return ins, t(viewmats), t(Ks), n_dead


def test_dead_slots_at_the_camera_centre():
    """K6's route culls the dead slots (their radii 0) and leaves the live
    rows' forward and gradients those of the plain path under autograd
    (the viewmats requiring grad), every gradient finite, the dead rows'
    zero; the plain path's dead rows are NaN."""
    ins, viewmats, Ks, n_dead = _dead_scene()
    n = ins[0].shape[0]
    cam = P.Pinhole(W, H, "RGB+ED", quat_order="wxyz")
    outs = P.project_fwd_plain(*ins, viewmats[0], Ks[0], cam)
    assert not outs[4][-n_dead:].any() and outs[4][:-n_dead].any()
    live = torch.arange(n) < n - n_dead

    def render(route_vm):
        leaves = [x.clone().requires_grad_(True) for x in ins]
        img, alpha, meta = prast.rasterize(*leaves, route_vm, Ks, W, H, max_per_tile=512,
                                           quat_order="wxyz", device="cpu")
        g = torch.Generator().manual_seed(2)
        ((img * torch.randn(img.shape, generator=g)).sum()
         + (alpha * torch.randn(alpha.shape, generator=g)).sum()).backward()
        return img, alpha, meta, [x.grad for x in leaves]

    img, alpha, meta, grads = render(viewmats)
    img_p, alpha_p, meta_p, grads_p = render(viewmats.clone().requires_grad_(True))
    assert torch.equal(img, img_p) and torch.equal(alpha, alpha_p)
    assert torch.equal(meta["radii"], meta_p["radii"])
    assert not torch.isfinite(grads_p[0][~live]).all()
    for name, a, r in zip(NAMES, grads, grads_p):
        assert torch.isfinite(a).all(), name
        rows = live.view((-1,) + (1,) * (a.dim() - 1))
        assert not torch.any(torch.where(rows, 0.0, a)), name
        _close_rel(a[live], r[live], name)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """A CPU tensor takes project_fwd_plain / project_bwd_plain and launches
    nothing."""
    ins, vm, K = _scene(0)
    cam = P.Pinhole(W, H, "RGB+ED", calc_compensations=True, quat_order="wxyz")
    n_fwd, n_bwd = P.project_fwd.launches, P.project_bwd.launches
    outs = P.project_fwd(*ins, vm, K, cam)
    for a, b in zip(outs, P.project_fwd_plain(*ins, vm, K, cam)):
        assert torch.equal(a, b)
    v = _cotangents(outs, cam)
    for a, b in zip(P.project_bwd(*ins, vm, K, cam, *v),
                    P.project_bwd_plain(*ins, vm, K, cam, *v)):
        assert torch.equal(a, b)
    assert (P.project_fwd.launches, P.project_bwd.launches) == (n_fwd, n_bwd)


def test_wrappers_hand_the_c_entries_their_arguments(monkeypatch):
    """Through a stand-in launch: each C entry gets as many arguments as
    its signature names, the flags' bits, and the cotangents' strides in
    elements (a transposed one as the rasterizer's backward hands it, a
    missing one as zeros); both wrappers count their launch."""
    calls = []
    monkeypatch.setattr(P, "check_device", lambda x, fn: False)
    monkeypatch.setattr(P, "launch", lambda src, fn, argtypes, dev, *args:
                        calls.append((fn, list(argtypes), args)))
    ins, vm, K = _scene(3)
    n = ins[0].shape[0]
    cam = P.Pinhole(W, H, "RGB+ED", calc_compensations=True, radius_clip=1.0,
                    quat_order="wxyz")
    n_fwd, n_bwd = P.project_fwd.launches, P.project_bwd.launches
    m2d, con, col, op, rad, dep = P.project_fwd(*ins, vm, K, cam)
    assert col.shape == (n, 4) and rad.dtype == torch.int32 and op.shape == (n,)
    rows = torch.zeros(12, n)
    v_col = rows[6:10].T                     # (n, 4), strides (1, n)
    P.project_bwd(*ins, vm, K, cam, rows[0:2].T, rows[2:5].T, v_col, rows[5], None)
    (fwd, fwd_types, fwd_args), (bwd, bwd_types, bwd_args) = calls
    assert (fwd, bwd) == ("project_fwd", "project_bwd")
    assert len(fwd_args) == len(fwd_types) and len(bwd_args) == len(bwd_types)
    assert fwd_args[20] == P._WXYZ | P._COMP | P._TIGHT | P._RGB | P._DEPTH | P._CLIP
    assert fwd_args[21:] == (3, 16, 3, 4)    # channels, SH coefficients, degree, D'
    assert list(bwd_args[12]) == [1, n, 1, n, 1, n, 1, 0, 0, 0]
    assert bwd_args[11] is None              # no depth cotangent
    assert (P.project_fwd.launches, P.project_bwd.launches) == (n_fwd + 1, n_bwd + 1)


@pytest.mark.parametrize("device,plain", [("cpu", True), ("meta", None)])
def test_kernel_wrappers_share_one_device_check(device, plain):
    """K6's wrappers and the rasterizer's take the one device check of
    ops/_launch: a CPU tensor runs the plain version, a device that is
    neither CPU nor CUDA is refused before anything runs."""
    from hunyuanworld_mirror_tpu_torch.ops import _launch, rasterizer_flat
    assert P.check_device is _launch.check_device is rasterizer_flat.check_device
    x = torch.zeros(2, 3, device=device)
    if plain is None:
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            P.project_fwd(x, x.new_zeros(2, 4), x, x.new_zeros(2), x,
                          x.new_zeros(4, 4), x.new_zeros(3, 3), P.Pinhole(W, H))
    else:
        assert _launch.check_device(x, "project_fwd") is plain


@pytest.mark.parametrize("route", ["pinhole", "ut", "pose"])
def test_rasterize_dispatch(route):
    """Pinhole cameras that take no gradient take K6's route, counted once a
    camera; a UT camera (fisheye) and viewmats that require grad keep the
    plain projection. The pose route renders what K6's route renders and
    gives the splats the same gradients."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(4), n=120, c=3)
    ins = [t(a).requires_grad_(True) for a in (means, quats, scales, opac, colors)]
    vm = t(viewmats).requires_grad_(route == "pose")
    kw = dict(max_per_tile=512, quat_order="wxyz", device="cpu",
              camera_model="fisheye" if route == "ut" else "pinhole")
    with pprof.recording() as rec, pprof.request():
        img, alpha, _ = prast.rasterize(*ins, vm, t(Ks), W, H, **kw)
    (req,) = rec.resolve()
    assert req.counts.get("project_fused", 0) == (3 if route == "pinhole" else 0)
    # one binning scalar a camera, and no quaternion index upload
    assert req.counts["host_syncs"] == 3
    if route != "pose":
        return
    (img * 0.3 + alpha).sum().backward()
    fused = [x.detach().clone().requires_grad_(True) for x in ins]
    img_f, alpha_f, _ = prast.rasterize(*fused, t(viewmats), t(Ks), W, H, **kw)
    assert torch.equal(img, img_f) and torch.equal(alpha, alpha_f)
    (img_f * 0.3 + alpha_f).sum().backward()
    for name, a, r in zip(NAMES, fused, ins):
        _close_rel(a.grad, r.grad, name)
