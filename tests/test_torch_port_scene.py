"""Port vs JAX on the GLB scene export (--glb, --glb-mesh, --mask-sky): the
edge masks and the sky heuristic equal, build_glb and predictions_to_glb
byte for byte the JAX writer's on the same arrays (points, single-frame
mesh, multi-frame mesh, sky mask on and off; the port's dict of torch
tensors against the JAX dict of numpy arrays)."""

import json
import struct

import numpy as np
import pytest
import torch

from torch_port_helpers import normal, uniform
from hunyuanworld_mirror_tpu.io import scene as jscene
from hunyuanworld_mirror_tpu_torch.io import scene as pscene

S, H, W = 3, 20, 24


def _sky_image(seed):
    """A bright, pale upper band over a dark, saturated ground."""
    img = uniform(seed, (H, W, 3), 0.0, 0.3)
    img[:H // 3] = uniform(seed + 1, (H // 3, W, 3), 0.8, 0.95)
    img[:H // 3, :, 2] = 0.97
    return img


def _preds(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (2.0 + 0.05 * xx + 0.5 * (xx > W // 2))[None].repeat(S, 0)
    depth = depth + rng.uniform(0, 0.01, depth.shape).astype(np.float32)
    pts = np.stack([xx[None] * 0.1 + np.arange(S)[:, None, None] * 0.02,
                    yy[None] * 0.1 + 0 * depth, depth], -1).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    c2w[:, 0, 3] = np.arange(S) * 0.3
    return {"pts3d": pts[None], "pts3d_conf": uniform(seed + 1, (1, S, H, W), 1.0, 3.0),
            "depth": depth[None, ..., None].astype(np.float32),
            "normals": normal(seed + 2, (1, S, H, W, 3)),
            "camera_poses": c2w[None],
            "images": np.stack([_sky_image(seed + 3 + s) for s in range(S)])[None]}


def test_edge_masks_and_sky_equal():
    p = _preds()
    d, n = p["depth"][0, ..., 0], p["normals"][0]
    for kw in (dict(rtol=0.03), dict(atol=0.2), dict(rtol=0.01, atol=0.3, kernel_size=5)):
        np.testing.assert_array_equal(pscene.depth_edge(d, **kw), jscene.depth_edge(d, **kw))
    m = d > 2.3
    np.testing.assert_array_equal(pscene.depth_edge(d, rtol=0.03, mask=m),
                                  jscene.depth_edge(d, rtol=0.03, mask=m))
    for kw in (dict(tol=30.0), dict(tol=10.0, kernel_size=5), dict(tol=30.0, mask=m)):
        np.testing.assert_array_equal(pscene.normals_edge(n, **kw),
                                      jscene.normals_edge(n, **kw))
    for s in range(S):
        img = p["images"][0, s]
        sky = pscene.sky_mask_heuristic(img)
        np.testing.assert_array_equal(sky, jscene.sky_mask_heuristic(img))
        np.testing.assert_array_equal(pscene.sky_mask(img), sky)
        assert sky[:H // 3].all() and not sky[H // 2:].any()


def test_build_glb_same_bytes():
    p = _preds(1)
    pts, cols = p["pts3d"][0, 0], p["images"][0, 0]
    valid = p["pts3d_conf"][0, 0] > 1.5
    for kw in (dict(), dict(valid=valid.reshape(-1)), dict(c2w=p["camera_poses"][0]),
               dict(c2w=p["camera_poses"][0], camera_scale=0.5)):
        assert (pscene.build_glb(pts.reshape(-1, 3), cols.reshape(-1, 3), **kw)
                == jscene.build_glb(pts.reshape(-1, 3), cols.reshape(-1, 3), **kw))
    mesh = dict(valid=valid, as_mesh=True, c2w=p["camera_poses"][0])
    glb = pscene.build_glb(pts, cols, **mesh)
    assert glb == jscene.build_glb(pts, cols, **mesh)
    magic, version, total = struct.unpack("<III", glb[:12])
    assert (magic, version, total) == (0x46546C67, 2, len(glb))
    n_js, kind = struct.unpack("<II", glb[12:20])
    assert kind == 0x4E4F534A
    assert json.loads(glb[20:20 + n_js])["meshes"][0]["primitives"][0]["mode"] == 4


@pytest.mark.parametrize("as_mesh,frame", [(False, None), (True, None), (True, 1)],
                         ids=["points", "multi_frame_mesh", "single_frame_mesh"])
@pytest.mark.parametrize("mask_sky", [False, True], ids=["no_sky", "sky"])
def test_predictions_to_glb_same_bytes(tmp_path, as_mesh, frame, mask_sky):
    p = _preds(2)
    tensors = {k: torch.tensor(v) for k, v in p.items()}
    kw = dict(conf_percent=20.0, mask_sky=mask_sky, as_mesh=as_mesh, frame=frame)
    ours = pscene.predictions_to_glb(tensors, str(tmp_path / "p.glb"), **kw)
    want = jscene.predictions_to_glb(p, str(tmp_path / "j.glb"), **kw)
    assert ours == str(tmp_path / "p.glb")
    assert open(ours, "rb").read() == open(want, "rb").read()
    # numpy in gives the same file
    pscene.predictions_to_glb(p, str(tmp_path / "n.glb"), **kw)
    assert (tmp_path / "n.glb").read_bytes() == (tmp_path / "p.glb").read_bytes()
