"""6D-pose training traffic: a pool of batches in the loader's layout,
drawn from the seed.

Parameters (wmbench/traffic/<name>.json, "kind": "sope"):
- batch, size: B images of size x size px a batch;
- pool: batches made at set-up; step i takes batch i mod pool;
- objects: [lo, hi], the objects an image holds, uniform;
- sigma_px: [lo, hi], each object's Gaussian blob's sigma in pixels;
- depth_m: [lo, hi], the depth's range in metres.
A batch holds, as training/data.ShardedLoader gives it (f32 numpy):
- rgb (B, size, size, 3) uniform in [0, 1];
- depth (B, size, size) uniform in depth_m;
- heatmap (B, size, size): each object a Gaussian blob at a random centre,
  the image's heat their maximum;
- pose_map (B, size / 2, size / 2, 12): under the blobs (heat >= 0.01 at
  the pixel), the owning object's rot6d (its rotation's first two
  columns), translation (x, y in +-0.5 m, z in 0.5-2.5 m) and box size
  (0.05-0.3 m a side); zero elsewhere.
Every seed gets the same shapes.
"""

import numpy as np


def _image(rng, size: int, params: dict):
    lo, hi = params["objects"]
    n = int(rng.integers(lo, hi + 1))
    ax = np.arange(size, dtype=np.float32)
    centres = rng.uniform(0, size, (n, 2)).astype(np.float32)
    sigma = rng.uniform(*params["sigma_px"], n).astype(np.float32)
    gy = np.exp(-(ax[None] - centres[:, :1]) ** 2 / (2 * sigma[:, None] ** 2))
    gx = np.exp(-(ax[None] - centres[:, 1:]) ** 2 / (2 * sigma[:, None] ** 2))
    blobs = gy[:, :, None] * gx[:, None, :]                    # (n, size, size)
    heat = blobs.max(0)
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    rot = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    rot[np.linalg.det(rot) < 0, :, 0] *= -1
    t = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), rng.uniform(0.5, 2.5, (n, 1))], 1)
    vec = np.concatenate([rot[:, :, :2].reshape(n, 6), t, rng.uniform(0.05, 0.3, (n, 3))], 1)
    owner = blobs[:, ::2, ::2].argmax(0)
    pose = np.where((heat[::2, ::2] >= 0.01)[..., None], vec[owner], 0.0)
    return heat, pose.astype(np.float32)


def make(params: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    B, size = params["batch"], params["size"]
    batches = []
    for _ in range(params["pool"]):
        heat, pose = zip(*(_image(rng, size, params) for _ in range(B)))
        batches.append({
            "rgb": rng.uniform(size=(B, size, size, 3)).astype(np.float32),
            "depth": rng.uniform(*params["depth_m"], (B, size, size)).astype(np.float32),
            "heatmap": np.stack(heat).astype(np.float32),
            "pose_map": np.stack(pose)})
    return {"batches": batches}
