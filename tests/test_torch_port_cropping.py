"""The port's io/cropping.py (a copy: numpy + cv2) against the JAX
package's, on the CPU, on seeded images: every function gives equal arrays
and intrinsics within 1e-12 (the same f64 arithmetic and the same cv2
calls on both sides)."""

import numpy as np
import pytest

from hunyuanworld_mirror_tpu.io import cropping as jc
from hunyuanworld_mirror_tpu_torch.io import cropping as pc


def _view(seed, w=200, h=140):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    depth = rng.uniform(0.5, 4.0, size=(h, w)).astype(np.float32)
    label = rng.integers(0, 7, size=(h, w)).astype(np.uint8)
    K = np.array([[170.0, 0, 97.3], [0, 165.0, 71.2], [0, 0, 1]])
    K[:2] *= rng.uniform(0.8, 1.2)
    return img, depth, label, K


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_intrinsics_conventions_match_jax():
    K = _view(0)[3]
    for name in ("opencv_to_colmap_intrinsics", "colmap_to_opencv_intrinsics"):
        _same(getattr(pc, name)(K), getattr(jc, name)(K))
    _same(pc.colmap_to_opencv_intrinsics(pc.opencv_to_colmap_intrinsics(K)), K)


@pytest.mark.parametrize("kw", [dict(scaling=0.75), dict(scaling=1.3, offset_factor=0.2),
                                dict(offset=(3.0, 7.5))])
def test_camera_matrix_of_crop_matches_jax(kw):
    K = _view(1)[3]
    _same(pc.camera_matrix_of_crop(K, (200, 140), (100, 80), **kw),
          jc.camera_matrix_of_crop(K, (200, 140), (100, 80), **kw))
    with pytest.raises(ValueError):
        pc.camera_matrix_of_crop(K, (200, 140), (300, 80))


@pytest.mark.parametrize("out_wh,force", [((126, 98), True), ((300, 220), True),
                                          ((300, 220), False)])
def test_rescale_with_intrinsics_matches_jax(out_wh, force):
    """Lanczos down, bicubic up, and force=False leaving a smaller image."""
    img, depth, label, K = _view(2)
    _same(pc.rescale_with_intrinsics(img, out_wh, depth, K, force, [label]),
          jc.rescale_with_intrinsics(img, out_wh, depth, K, force, [label]))


def test_crop_and_bbox_match_jax():
    img, depth, label, K = _view(3)
    _same(pc.crop_with_intrinsics(img, (10, 20, 110, 100), depth, K, [label]),
          jc.crop_with_intrinsics(img, (10, 20, 110, 100), depth, K, [label]))
    K_out = K.copy()
    K_out[:2, 2] -= (12.4, 30.6)
    assert pc.bbox_from_intrinsics_in_out(K, K_out, (96, 64)) == \
        jc.bbox_from_intrinsics_in_out(K, K_out, (96, 64))


@pytest.mark.parametrize("res", [(126, 98), (252, 196), (518, 392)])
@pytest.mark.parametrize("extras", [False, True])
def test_crop_resize_if_necessary_matches_jax(res, extras):
    """With depth, intrinsics and label maps, and with the image alone
    (the variadic return)."""
    img, depth, label, K = _view(4)
    kw = dict(depthmap=depth, intrinsics=K, extras=[label]) if extras else {}
    ours, ref = pc.crop_resize_if_necessary(img, res, **kw), \
        jc.crop_resize_if_necessary(img, res, **kw)
    assert len(ours) == len(ref) == (4 if extras else 1)
    assert ours[0].shape == (res[1], res[0], 3)
    _same(ours, ref)


def test_resizes_need_cv2(monkeypatch):
    """Without cv2 the resizes raise ImportError on both sides."""
    img = _view(5)[0]
    for mod in (pc, jc):
        monkeypatch.setattr(mod, "cv2", None)
        with pytest.raises(ImportError, match="cv2"):
            mod.rescale_with_intrinsics(img, (100, 70))
        with pytest.raises(ImportError, match="cv2"):
            mod._resize_nearest(img, (100, 70))
