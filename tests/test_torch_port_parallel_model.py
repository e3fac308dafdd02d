"""The port's sharded model, distributed render, sharded BA and sharded
checkpoints against the JAX package, on gloo process groups over the CPU.

The port runs in 2 and 4 processes (parallel.mesh.spawn, a `file://`
store; they import no JAX), the JAX side here on the 8-device CPU mesh of
tests/conftest.py, with the same numpy inputs and the port's seeded init
converted for JAX by tools/convert_weights.

Bands:
- the toy WorldMirror (multichip.TOY, __graft_entry__.dryrun_multichip's
  config, its DPT decoders narrowed to width 32 as the tiny configs of
  test_torch_port_model.py narrow them) at meshes (1,2,1), (1,2,2) and
  (2,2,1), f32 trunk, render on, against JAX's worldmirror.forward(...,
  ring_mesh=make_mesh(...)): the cameras and every dense head 2e-4 as
  test_ring.py:84; the splats and renders at the full-model parity bands
  of test_forward_matches_jax (test_full_model_parity.compare_geometry:
  few splats survive the voxel merge at this size, and a mean on a voxel
  edge that floors the other way in one package moves a merged splat in
  the rows and the renders, unsharded as much as sharded). Against the
  port's own unsharded forward the splats hold as sets of rows at atol
  1e-5 (at most 4 rows may miss it: the ring moves the means by ~1e-7,
  enough to floor a mean on a voxel edge the other way) and the renders
  at median |d| <= 1e-5, 95% of values within 1e-4 and all within 5e-2
  (compare_geometry's outlier bound; measured: median ~1e-6, 0.9-3.1% of
  values beyond 1e-4, max 6e-4 to 9e-3, from such moved splats);
- rasterize_distributed at V = 2 and 4 against JAX's at make_mesh(1, V, 1)
  on tests/test_distributed_raster.py's scene: RGB+ED and SH colours at
  atol 2e-5, rtol 1e-4 (test_distributed_raster.py:46-49), the gradients
  of sum(out^2) w.r.t. means and opacities at atol 1e-4, rtol 1e-3
  (:74-77);
- bundle_adjust with the landmarks sharded over V = 2 and 4 against JAX's
  sharded BA on tests/test_ba.py's problem: poses atol 1e-4, rtol 1e-4,
  the final cost atol 1e-6 (test_ba.py:69-72);
- save_sharded / load_sharded: bit-exact round trips, on the same mesh and
  onto one process;
- the prior path (pose, depth and ray priors, every cond flag) at (1,2,1)
  against the port's unsharded forward: 1e-5 (f32; the ring's summation
  order only).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_full_model_parity as tp
from torch_port_helpers import (TOY_NARROW, TOY_PRED_KEYS, ba_worker, checkpoint_worker,
                                close_splat_sets, jobs_worker, model_worker,
                                np_, raster_worker, spawn_gloo, state_dict_np,
                                toy_model, uniform)
from hunyuanworld_mirror_tpu.models import worldmirror as jwm
from hunyuanworld_mirror_tpu.ops import distributed as jdist
from hunyuanworld_mirror_tpu.parallel import mesh as jmesh
from hunyuanworld_mirror_tpu.refine import ba as jba
from hunyuanworld_mirror_tpu.utils.rotation import se3_exp
from hunyuanworld_mirror_tpu_torch import multichip
from hunyuanworld_mirror_tpu_torch.training import checkpoint
from tools import convert_weights as cw

MESHES = {2: [(1, 2, 1)], 4: [(1, 2, 2), (2, 2, 1)]}


def _scene(seed, N=256, C=8, sh=False):
    """tests/test_distributed_raster.py's scene (numpy, f32)."""
    rng = np.random.default_rng(seed)
    means = (rng.uniform(-1, 1, (N, 3)) + [0, 0, 3.0]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(-4, -2.3, (N, 3))).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, (N,)).astype(np.float32)
    colors = (rng.normal(0, 0.3, (N, 4, 3)) if sh else
              rng.uniform(0, 1, (N, 3))).astype(np.float32)
    viewmats = np.broadcast_to(np.eye(4, dtype=np.float32), (C, 4, 4)).copy()
    viewmats[:, 0, 3] = np.linspace(-0.2, 0.2, C)
    Ks = np.broadcast_to(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]],
                                  np.float32), (C, 3, 3)).copy()
    return [means, quats, scales, opac, colors, viewmats, Ks]


RASTER_CASES = {"rgb_ed": (0, False, 64, "RGB+ED", None),
                "sh": (1, True, 32, "RGB", 1)}


def _priors(B=2, S=4, HW=28):
    """Camera-to-world poses turning about y and moving, their K, and depth
    maps: every prior the model takes."""
    pose = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    for s in range(S):
        a = 0.05 * s
        pose[:, s, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        pose[:, s, :3, 3] = [0.05 * s, -0.02 * s, 0.03 * s]
    K = np.tile(np.array([[30, 0, HW / 2], [0, 28, HW / 2], [0, 0, 1]], np.float32),
                (B, S, 1, 1))
    return {"camera_pose": pose, "camera_intrinsics": K,
            "depthmap": uniform(9, (B, S, HW, HW), 0.5, 6.0)}


def _ba_problem(seed, S=4, M=64):
    """tests/test_ba.py's synthetic problem, perturbed cameras."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (M, 3)) + np.array([0, 0, 4.0])
    K = np.broadcast_to(np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]]), (S, 3, 3))
    w2c = np.asarray(se3_exp(jnp.asarray(rng.uniform(-0.05, 0.05, (S, 6)))))
    uv, _, _ = jba._project(jnp.asarray(pts), jnp.asarray(w2c), jnp.asarray(K))
    w2c0 = np.asarray(se3_exp(jnp.asarray(rng.uniform(-0.02, 0.02, (S, 6))))) @ w2c
    tracks = [pts.astype(np.float32), np.asarray(uv, np.float32),
              np.ones((M, S), bool), np.ones((M, S), np.float32)]
    return w2c0.astype(np.float32), K.astype(np.float32), tracks


@pytest.fixture(scope="module")
def toy():
    model = toy_model()
    state = state_dict_np(model)
    img = uniform(0, (2, 4, 28, 28, 3))
    return state, img


@pytest.fixture(scope="module")
def port_runs(toy, tmp_path_factory):
    """Every port case, in one process group of 2 and one of 4, started in
    the background while the JAX side compiles -> (future of {n: results},
    {n: checkpoint directory})."""
    state, img = toy
    other = state_dict_np(toy_model(seed=1))
    paths = {n: str(tmp_path_factory.mktemp(f"ckpt{n}")) for n in (2, 4)}
    w2c0, K, tracks = _ba_problem(0)

    def run(n):
        jobs = [(model_worker, (state, img, MESHES[n]))]
        if n == 2:
            jobs.append((model_worker, (state, img, MESHES[n], _priors())))
        jobs += [(raster_worker, (_scene(seed, sh=sh), W, W, mode, deg))
                 for seed, sh, W, mode, deg in RASTER_CASES.values()]
        jobs += [(ba_worker, (w2c0, K, tracks, 8)),
                 (checkpoint_worker, ((1, n // 2, 2), paths[n], state, other))]
        return spawn_gloo(jobs_worker, n, jobs)

    pool = ThreadPoolExecutor(2)
    runs = {n: pool.submit(run, n) for n in (2, 4)}
    yield _Runs(runs), paths
    pool.shutdown()


class _Runs:
    """The port's results by world size, waited for when first read."""

    def __init__(self, futures):
        self.futures = futures

    def result(self):
        return {n: f.result() for n, f in self.futures.items()}


def _jax_forward(state, img, dims):
    params = cw.convert_worldmirror(dict(state))
    cfg = jwm.WorldMirrorConfig(**multichip.TOY, **TOY_NARROW)
    mesh = jmesh.make_mesh(*dims)
    out = jax.jit(lambda p, v: jwm.forward(p, cfg, v, render=True, ring_mesh=mesh,
                                           trunk_dtype=jnp.float32))(
        params, {"img": jnp.asarray(img)})
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def unsharded(toy):
    state, img = toy
    out = toy_model(state)({"img": torch.tensor(img)}, trunk_dtype=torch.float32)
    return {k: ({kk: np_(vv) for kk, vv in v.items()} if isinstance(v, dict) else np_(v))
            for k, v in out.items()}


def _batch(preds, b):
    """One batch element of a prediction dict in compare_geometry's form
    (batch 1; the reference's splats as ragged live lists)."""
    out = {k: v[b:b + 1] for k, v in preds.items() if not isinstance(v, dict)}
    out["splats"] = {k: v[b:b + 1] for k, v in preds["splats"].items()}
    return out


def _ragged(splats):
    live = [splats["weights"][b] > 0 for b in range(splats["weights"].shape[0])]
    return {k: [splats[k][b][m] for b, m in enumerate(live)]
            for k in ("means", "quats", "scales", "opacities", "sh")}


@pytest.mark.parametrize("dims", [(1, 2, 1), (1, 2, 2), (2, 2, 1)],
                         ids=["mesh121", "mesh122", "mesh221"])
def test_sharded_forward_matches_jax(toy, port_runs, unsharded, dims):
    state, img = toy
    n = int(np.prod(dims))
    ref = _jax_forward(state, img, dims)
    ranks = port_runs[0].result()[n]
    ours = ranks[0][0][MESHES[n].index(dims)]
    for k in TOY_PRED_KEYS:
        if not k.startswith("rendered"):
            np.testing.assert_allclose(ours[k], ref[k], atol=2e-4, rtol=2e-4, err_msg=k)
    for b in range(img.shape[0]):
        r = _batch(ref, b)
        tp.compare_geometry(_batch(ours, b), {**r, "splats": _ragged(r["splats"])})
    close_splat_sets(ours["splats"], unsharded["splats"], atol=1e-5, flip_frac=0.01)
    for k in ("rendered_colors", "rendered_alphas", "rendered_depths"):
        d = np.abs(ours[k] - unsharded[k])
        assert float(np.median(d)) <= 1e-5, (k, float(np.median(d)))
        assert float((d > 1e-4).mean()) <= 0.05, (k, float((d > 1e-4).mean()))
        assert float(d.max()) <= 5e-2, (k, float(d.max()))
    # every rank gathered the same outputs
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[0][MESHES[n].index(dims)]["depth"],
                                      ours["depth"])


def test_sharded_prior_forward_matches_unsharded(toy, port_runs):
    """Every prior and cond flag at mesh (1,2,1): the pose normalisation
    spans all views, so the ranks gather the priors first; the outputs
    against the port's own unsharded forward with the same priors."""
    state, img = toy
    priors = _priors()
    ref = toy_model(state)({"img": torch.tensor(img),
                            **{k: torch.tensor(v) for k, v in priors.items()}},
                           cond_flags=(1, 1, 1), trunk_dtype=torch.float32)
    ours = port_runs[0].result()[2][0][1][0]
    for k in ("depth", "pts3d", "normals", "camera_params", "gs_depth"):
        np.testing.assert_allclose(ours[k], np_(ref[k]), atol=1e-5, rtol=1e-5, err_msg=k)


def _jax_raster(scene, W, mode, deg, V):
    mesh = jmesh.make_mesh(1, V, 1)
    args = [jnp.asarray(a) for a in scene]

    def run(means, opac):
        return jdist.rasterize_distributed(
            means, args[1], args[2], opac, args[4], args[5], args[6], width=W,
            height=W, mesh=mesh, axis="view", render_mode=mode, impl="jax",
            sh_degree=deg)

    out, alpha = jax.jit(run)(args[0], args[3])
    grads = jax.jit(jax.grad(lambda m, o: jnp.sum(run(m, o)[0] ** 2),
                             argnums=(0, 1)))(args[0], args[3])
    return [np.asarray(x) for x in (out, alpha) + tuple(grads)]


@pytest.mark.parametrize("V", [2, 4])
@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_rasterize_distributed_matches_jax(port_runs, V, case):
    seed, sh, W, mode, deg = RASTER_CASES[case]
    ref = _jax_raster(_scene(seed, sh=sh), W, mode, deg, V)
    first = 2 if V == 2 else 1
    ranks = [r[first + list(RASTER_CASES).index(case)] for r in port_runs[0].result()[V]]
    ours = [np.concatenate([r[i] for r in ranks]) for i in range(4)]
    for i, name in enumerate(("colors", "alphas")):
        np.testing.assert_allclose(ours[i], ref[i], atol=2e-5, rtol=1e-4, err_msg=name)
    for i, name in ((2, "d means"), (3, "d opacities")):
        assert float(np.abs(ref[i]).max()) > 0
        np.testing.assert_allclose(ours[i], ref[i], atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("V", [2, 4])
def test_sharded_ba_matches_jax(port_runs, V):
    w2c0, K, tracks = _ba_problem(0)
    mesh = jmesh.make_mesh(1, V, 1)
    poses, pts, cost0, cost = jax.jit(lambda w, t: jba.bundle_adjust(
        w, jnp.asarray(K), t, iters=8, mesh=mesh))(
        jnp.asarray(w2c0), jba.Tracks(*(jnp.asarray(a) for a in tracks)))
    o_poses, o_pts, o_cost0, o_cost = port_runs[0].result()[V][0][-2]
    np.testing.assert_allclose(o_poses, np.asarray(poses), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(o_cost, float(cost), atol=1e-6)
    np.testing.assert_allclose(o_cost0, float(cost0), rtol=1e-5)
    assert o_pts.shape == np.asarray(pts).shape
    for r in port_runs[0].result()[V][1:]:
        np.testing.assert_array_equal(r[-2][0], o_poses)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_checkpoint_round_trips(toy, port_runs, n):
    """Saved at mesh (1, n/2, 2) after one step, loaded onto a model made
    from other weights on the same mesh: every parameter and Adam moment
    comes back, and the step and counts."""
    saved, loaded, (step, adam_count, sched), moments = port_runs[0].result()[n][0][-1]
    assert set(saved) == set(loaded)
    for k in saved:
        np.testing.assert_array_equal(loaded[k], saved[k], err_msg=k)
    assert (step, adam_count, sched) == (7, 1, 1) and moments


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_checkpoint_loads_on_one_process(port_runs, n):
    """The directory loads as the whole state dict with no process group,
    and into an unsharded model, equal to the gathered state."""
    saved = port_runs[0].result()[n][0][-1][0]
    whole, step = checkpoint.load_sharded(port_runs[1][n])
    assert step == 7 and set(whole) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(whole[k].numpy(), v, err_msg=k)
    model = toy_model()
    checkpoint.load_sharded(port_runs[1][n], model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved[k], err_msg=k)
