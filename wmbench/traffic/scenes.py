"""Scene traffic: a pool of multi-view image sets drawn from the seed.

Parameters (wmbench/traffic/<name>.json, "kind": "scenes"):
- views, size: S images of size x size px a scene, uniform in [0, 1];
- batch: scenes a request (B);
- pool: scenes made at set-up; request i takes scene i mod pool;
- cameras: "fixed_ring" (frozen/scenes.fixed_cameras(S)), the cameras the
  render uses in place of the model's prediction;
- sample: pool scenes, drawn from the seed, whose latest request's outputs
  the check compares with the reference once the window has closed.
Every seed gets the same sizes and cameras; only the pixels and the sample
change.
"""

import numpy as np

from wmbench.frozen.scenes import fixed_cameras


def make(params: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    S, size, B = params["views"], params["size"], params["batch"]
    scenes = rng.uniform(size=(params["pool"], B, S, size, size, 3)).astype(np.float32)
    if params["cameras"] != "fixed_ring":
        raise ValueError(f"unknown cameras {params['cameras']!r}")
    cams = np.repeat(fixed_cameras(S), B, axis=0)
    sample = sorted(int(k) for k in rng.choice(params["pool"], params["sample"],
                                               replace=False))
    return {"scenes": scenes, "cameras": cams, "sample": sample}
