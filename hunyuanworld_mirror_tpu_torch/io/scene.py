"""Scene export and masking (numpy): the GLB builder, depth and normal
edge masks, the sky mask.

A copy of hunyuanworld_mirror_tpu/io/scene.py (the port imports nothing of
the JAX package): the binary glTF 2.0 container written directly (a JSON
chunk and one binary buffer of positions, colours and indices; point clouds
as POINTS with COLOR_0, meshes as grid-triangulated pointmaps, camera
frusta as LINES), the reference's max-pool edge masks, and the sky mask:
the reference's skyseg.onnx through onnxruntime when a model path is given
and onnxruntime imports, else the HSV heuristic (bright, low-saturation
pixels grown down from the top border). The files are byte for byte the JAX
writer's, its generator name included. `predictions_to_glb` takes the
port's prediction dict: torch tensors (on any device) or numpy arrays.
"""

import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# edge masks (reference src/utils/geometry.py)
# ---------------------------------------------------------------------------

def _max_pool2d(x: np.ndarray, kernel_size: int) -> np.ndarray:
    """Stride-1 same-size max pool over the last two axes, -inf padded."""
    from scipy.ndimage import maximum_filter
    size = (1,) * (x.ndim - 2) + (kernel_size, kernel_size)
    return maximum_filter(x, size=size, mode="constant", cval=-np.inf)


def depth_edge(depth: np.ndarray, atol: Optional[float] = None,
               rtol: Optional[float] = None, kernel_size: int = 3,
               mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Pixels whose window depth range exceeds atol (absolute) or rtol
    (relative to the center depth). depth (..., H, W) -> bool mask."""
    depth = np.asarray(depth, np.float32)
    if mask is None:
        diff = _max_pool2d(depth, kernel_size) + _max_pool2d(-depth, kernel_size)
    else:
        diff = (_max_pool2d(np.where(mask, depth, -np.inf), kernel_size)
                + _max_pool2d(np.where(mask, -depth, -np.inf), kernel_size))
    edge = np.zeros(depth.shape, bool)
    if atol is not None:
        edge |= diff > atol
    if rtol is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            edge |= (diff / depth) > rtol
    return edge


def normals_edge(normals: np.ndarray, tol: float, kernel_size: int = 3,
                 mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Pixels where the angle to some window neighbor exceeds `tol` degrees.

    normals (..., H, W, 3) -> bool (..., H, W). The reference computes the
    max window angle then max-pools it once more; both steps reproduced."""
    n = np.asarray(normals, np.float32)
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    pad = kernel_size // 2
    padded = np.pad(n, (*([(0, 0)] * (n.ndim - 3)),
                        (pad, pad), (pad, pad), (0, 0)), mode="edge")
    H, W = n.shape[-3], n.shape[-2]
    worst = np.zeros(n.shape[:-1], np.float32)
    for dy in range(kernel_size):
        for dx in range(kernel_size):
            nb = padded[..., dy:dy + H, dx:dx + W, :]
            dot = np.clip((n * nb).sum(-1), -1.0, 1.0)
            if mask is not None:
                nb_mask = np.pad(mask, (*([(0, 0)] * (mask.ndim - 2)),
                                        (pad, pad), (pad, pad)),
                                 mode="edge")[..., dy:dy + H, dx:dx + W]
                ang = np.where(nb_mask, np.arccos(dot), 0.0)
            else:
                ang = np.arccos(dot)
            worst = np.maximum(worst, ang)
    worst = _max_pool2d(worst, kernel_size)
    return worst > np.deg2rad(tol)


# ---------------------------------------------------------------------------
# sky segmentation (reference visual_util.py:20-84)
# ---------------------------------------------------------------------------

def sky_mask(image: np.ndarray, onnx_path: Optional[str] = None) -> np.ndarray:
    """(H, W, 3) [0,1] image -> bool mask of sky pixels.

    Uses the reference's skyseg.onnx when a model path is given and
    onnxruntime is importable; otherwise `sky_mask_heuristic`."""
    if onnx_path is not None:
        try:
            return _sky_mask_onnx(image, onnx_path)
        except ImportError:
            pass
    return sky_mask_heuristic(image)


def _sky_mask_onnx(image: np.ndarray, onnx_path: str) -> np.ndarray:
    import cv2
    import onnxruntime as ort

    sess = ort.InferenceSession(onnx_path, providers=["CPUExecutionProvider"])
    H, W = image.shape[:2]
    inp = cv2.resize((image * 255).astype(np.uint8), (320, 320)).astype(np.float32)
    inp = (inp / 255.0 - 0.5) / 0.5
    out = sess.run(None, {sess.get_inputs()[0].name:
                          inp.transpose(2, 0, 1)[None]})[0][0, 0]
    out = cv2.resize(out, (W, H))
    return out > 0.3  # reference threshold (visual_util.py:76)


def sky_mask_heuristic(image: np.ndarray, value_min: float = 0.55,
                       sat_max: float = 0.45, top_frac: float = 0.6) -> np.ndarray:
    """Heuristic stand-in for the ONNX segmenter: bright,
    low-saturation-or-blue pixels flood-grown downward from the top border.
    Column-wise growth stops at the first non-sky pixel, so ground objects
    below the horizon never join the mask."""
    img = np.asarray(image, np.float32)
    v = img.max(-1)
    mn = img.min(-1)
    sat = np.where(v > 1e-6, (v - mn) / np.maximum(v, 1e-6), 0.0)
    blueish = img[..., 2] >= img[..., 0]
    candidate = (v > value_min) & ((sat < sat_max) | (blueish & (sat < 0.75)))
    H = img.shape[0]
    limit = int(H * top_frac)
    candidate[limit:] = False
    # column-wise prefix: sky = candidate run starting at row 0
    grown = np.logical_and.accumulate(candidate, axis=0)
    return grown


# ---------------------------------------------------------------------------
# GLB (binary glTF 2.0) writer — hand-rolled, no trimesh
# ---------------------------------------------------------------------------

_COMP_F32, _COMP_U32, _COMP_U8 = 5126, 5125, 5121
_TARGET_ARRAY, _TARGET_ELEMENT = 34962, 34963
_MODE_POINTS, _MODE_LINES, _MODE_TRIANGLES = 0, 1, 4


class _GlbBuilder:
    def __init__(self):
        self.buf = bytearray()
        self.views: List[dict] = []
        self.accessors: List[dict] = []
        self.meshes: List[dict] = []
        self.nodes: List[dict] = []

    def _align(self, n=4):
        while len(self.buf) % n:
            self.buf.append(0)

    def add_accessor(self, array: np.ndarray, component: int, type_str: str,
                     target: int, normalized: bool = False) -> int:
        self._align()
        offset = len(self.buf)
        data = np.ascontiguousarray(array)
        self.buf.extend(data.tobytes())
        self.views.append({"buffer": 0, "byteOffset": offset,
                           "byteLength": data.nbytes, "target": target})
        acc = {"bufferView": len(self.views) - 1, "componentType": component,
               "count": int(array.shape[0]), "type": type_str}
        if normalized:
            acc["normalized"] = True
        if type_str == "VEC3" and component == _COMP_F32 and len(array):
            acc["min"] = np.asarray(array.min(0), np.float64).tolist()
            acc["max"] = np.asarray(array.max(0), np.float64).tolist()
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_primitive_node(self, attributes: dict, mode: int,
                           indices: Optional[int] = None,
                           name: str = "geom"):
        prim = {"attributes": attributes, "mode": mode}
        if indices is not None:
            prim["indices"] = indices
        self.meshes.append({"primitives": [prim], "name": name})
        self.nodes.append({"mesh": len(self.meshes) - 1, "name": name})

    def finish(self) -> bytes:
        self._align()
        gltf = {
            "asset": {"version": "2.0", "generator": "hunyuanworld_mirror_tpu"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(self.nodes)))}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "buffers": [{"byteLength": len(self.buf)}],
            "bufferViews": self.views,
            "accessors": self.accessors,
        }
        js = json.dumps(gltf, separators=(",", ":")).encode()
        js += b" " * (-len(js) % 4)
        total = 12 + 8 + len(js) + 8 + len(self.buf)
        out = bytearray()
        out += struct.pack("<III", 0x46546C67, 2, total)          # glTF v2
        out += struct.pack("<II", len(js), 0x4E4F534A) + js       # JSON
        out += struct.pack("<II", len(self.buf), 0x004E4942) + self.buf  # BIN
        return bytes(out)


def _add_points(b: _GlbBuilder, points: np.ndarray, colors: np.ndarray):
    pos = b.add_accessor(points.astype(np.float32), _COMP_F32, "VEC3",
                         _TARGET_ARRAY)
    col = b.add_accessor(colors.astype(np.uint8), _COMP_U8, "VEC3",
                         _TARGET_ARRAY, normalized=True)
    b.add_primitive_node({"POSITION": pos, "COLOR_0": col}, _MODE_POINTS,
                         name="points")


def _grid_mesh(points: np.ndarray, colors: np.ndarray, valid: np.ndarray,
               max_edge: Optional[float] = None):
    """Triangulate an (H, W, 3) pointmap: two triangles per pixel quad whose
    four corners are valid (reference visual_util.py:109-206 quad mesh)."""
    H, W, _ = points.shape
    idx = np.arange(H * W).reshape(H, W)
    q = valid[:-1, :-1] & valid[:-1, 1:] & valid[1:, :-1] & valid[1:, 1:]
    if max_edge is not None:
        d = np.linalg.norm(points[:-1, :-1] - points[1:, 1:], axis=-1)
        q &= d < max_edge
    a, bq = idx[:-1, :-1][q], idx[:-1, 1:][q]
    c, dq = idx[1:, :-1][q], idx[1:, 1:][q]
    tris = np.concatenate([np.stack([a, dq, bq], -1),
                           np.stack([a, c, dq], -1)], 0)
    return points.reshape(-1, 3), colors.reshape(-1, 3), tris.astype(np.uint32)


def _camera_frustum_lines(c2w: np.ndarray, scale: float) -> np.ndarray:
    """Wireframe pyramid (5 vertices, 8 edges) in world space -> (16, 3)
    LINES vertex list."""
    corners = np.array([[-1, -1, 1.5], [1, -1, 1.5], [1, 1, 1.5], [-1, 1, 1.5]],
                       np.float32) * scale
    apex = np.zeros((1, 3), np.float32)
    pts_c = np.concatenate([apex, corners])
    R, t = c2w[:3, :3], c2w[:3, 3]
    pts_w = pts_c @ R.T + t
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return np.concatenate([pts_w[[i, j]] for i, j in edges], 0)


def build_glb(points: np.ndarray, colors: np.ndarray,
              c2w: Optional[np.ndarray] = None,
              valid: Optional[np.ndarray] = None,
              as_mesh: bool = False,
              camera_scale: Optional[float] = None) -> bytes:
    """Build a GLB scene.

    Args:
      points: (H, W, 3) pointmap when as_mesh, else (N, 3).
      colors: matching RGB in [0, 1] or uint8.
      c2w: optional (S, 4, 4) camera-to-world poses -> frusta wireframes.
      valid: optional bool mask ((H, W) or (N,)).
    """
    b = _GlbBuilder()
    colors = np.asarray(colors)
    if colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)

    if as_mesh:
        assert points.ndim == 3, "as_mesh needs an (H, W, 3) pointmap"
        v = valid if valid is not None else np.ones(points.shape[:2], bool)
        verts, cols, tris = _grid_mesh(points, colors.reshape(points.shape), v)
        pos = b.add_accessor(verts.astype(np.float32), _COMP_F32, "VEC3",
                             _TARGET_ARRAY)
        col = b.add_accessor(cols, _COMP_U8, "VEC3", _TARGET_ARRAY,
                             normalized=True)
        ind = b.add_accessor(tris.reshape(-1), _COMP_U32, "SCALAR",
                             _TARGET_ELEMENT)
        b.add_primitive_node({"POSITION": pos, "COLOR_0": col},
                             _MODE_TRIANGLES, indices=ind, name="pointmap_mesh")
    else:
        pts = points.reshape(-1, 3)
        cols = colors.reshape(-1, 3)
        if valid is not None:
            m = valid.reshape(-1)
            pts, cols = pts[m], cols[m]
        _add_points(b, pts, cols)

    if c2w is not None and len(c2w):
        if camera_scale is None:
            span = np.linalg.norm(
                points.reshape(-1, 3).max(0) - points.reshape(-1, 3).min(0))
            camera_scale = float(max(span, 1e-3)) * 0.03
        lines = np.concatenate(
            [_camera_frustum_lines(np.asarray(m), camera_scale) for m in c2w])
        pos = b.add_accessor(lines.astype(np.float32), _COMP_F32, "VEC3",
                             _TARGET_ARRAY)
        col = b.add_accessor(
            np.tile(np.array([255, 64, 64], np.uint8), (len(lines), 1)),
            _COMP_U8, "VEC3", _TARGET_ARRAY, normalized=True)
        b.add_primitive_node({"POSITION": pos, "COLOR_0": col}, _MODE_LINES,
                             name="cameras")
    return b.finish()


def _np(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array -> numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def predictions_to_glb(predictions: Dict, path: str,
                       conf_percent: float = 20.0,
                       mask_sky: bool = False,
                       mask_edges: bool = True,
                       as_mesh: bool = False,
                       show_cameras: bool = True,
                       frame: Optional[int] = None,
                       onnx_path: Optional[str] = None) -> str:
    """Export a prediction dict (batch 0) to a GLB scene file.

    Mirrors the reference app's masking stack (app.py:148-200): confidence
    percentile + optional sky mask + depth/normal edge masks."""
    pts = _np(predictions["pts3d"][0])          # (S, H, W, 3)
    conf = _np(predictions["pts3d_conf"][0])
    imgs = _np(predictions["images"][0]) if "images" in predictions \
        else np.full(pts.shape, 0.7, np.float32)
    S, H, W, _ = pts.shape

    valid = conf >= np.percentile(conf, conf_percent)
    if mask_edges and "depth" in predictions:
        d = _np(predictions["depth"][0, ..., 0])
        valid &= ~depth_edge(d, rtol=0.03)
    if mask_edges and "normals" in predictions:
        valid &= ~normals_edge(_np(predictions["normals"][0]), tol=30.0)
    if mask_sky:
        for s in range(S):
            valid[s] &= ~sky_mask(imgs[s], onnx_path)

    if frame is not None:
        pts, imgs, valid = pts[frame:frame + 1], imgs[frame:frame + 1], \
            valid[frame:frame + 1]

    c2w = _np(predictions["camera_poses"][0]) if (
        show_cameras and "camera_poses" in predictions) else None

    if as_mesh:
        # one mesh per frame stitched into a single vertex soup
        glb = build_glb(pts[0], imgs[0], c2w=c2w, valid=valid[0], as_mesh=True) \
            if pts.shape[0] == 1 else _multi_frame_mesh(pts, imgs, valid, c2w)
    else:
        glb = build_glb(pts.reshape(-1, 3), imgs.reshape(-1, 3), c2w=c2w,
                        valid=valid.reshape(-1))
    with open(path, "wb") as f:
        f.write(glb)
    return path


def _multi_frame_mesh(pts, imgs, valid, c2w) -> bytes:
    b = _GlbBuilder()
    all_v, all_c, all_t, base = [], [], [], 0
    for s in range(pts.shape[0]):
        v, c, t = _grid_mesh(pts[s], (np.clip(imgs[s], 0, 1) * 255).astype(np.uint8),
                             valid[s])
        all_v.append(v)
        all_c.append(c)
        all_t.append(t + base)
        base += len(v)
    verts = np.concatenate(all_v)
    pos = b.add_accessor(verts.astype(np.float32), _COMP_F32, "VEC3",
                         _TARGET_ARRAY)
    col = b.add_accessor(np.concatenate(all_c), _COMP_U8, "VEC3",
                         _TARGET_ARRAY, normalized=True)
    ind = b.add_accessor(np.concatenate(all_t).reshape(-1), _COMP_U32,
                         "SCALAR", _TARGET_ELEMENT)
    b.add_primitive_node({"POSITION": pos, "COLOR_0": col}, _MODE_TRIANGLES,
                         indices=ind, name="pointmap_mesh")
    if c2w is not None:
        span = np.linalg.norm(verts.max(0) - verts.min(0)) if len(verts) else 1.0
        lines = np.concatenate(
            [_camera_frustum_lines(np.asarray(m), span * 0.03) for m in c2w])
        p2 = b.add_accessor(lines.astype(np.float32), _COMP_F32, "VEC3",
                            _TARGET_ARRAY)
        c2 = b.add_accessor(
            np.tile(np.array([255, 64, 64], np.uint8), (len(lines), 1)),
            _COMP_U8, "VEC3", _TARGET_ARRAY, normalized=True)
        b.add_primitive_node({"POSITION": p2, "COLOR_0": c2}, _MODE_LINES,
                             name="cameras")
    return b.finish()
