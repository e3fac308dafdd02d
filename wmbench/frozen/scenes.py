"""The camera ring that gives the render a real scene's load.

Frozen copy of `fixed_cameras` of hunyuanworld_mirror_tpu_torch/utils/
scenes.py at commit e2e15df8eb5b1f9149d8000ecb6c575b37fbec06. On random
weights the model's own predicted cameras leave the render nearly empty
(~19k intersections a camera against ~630k through this ring).
"""

import math

import numpy as np


def fixed_cameras(S):
    """Identity-ish rotations, small translations, ~60 degree fov: (1, S, 9)
    camera vectors [t, quat xyzw, fov_v, fov_u]."""
    cams = np.zeros((1, S, 9), np.float32)
    for s in range(S):
        a = 0.05 * s
        cams[0, s, :3] = [0.05 * s, -0.02 * s, 0.03 * s]
        cams[0, s, 3:7] = [0.0, math.sin(a / 2), 0.0, math.cos(a / 2)]  # xyzw
        cams[0, s, 7:9] = math.radians(60)
    return cams
