"""Animated splat effects for novel-view videos (numpy, on the host).

A copy of hunyuanworld_mirror_tpu/io/effects.py (the port imports nothing of
the JAX package), itself a port of the reference's GLSL-style effects
(gs_effects.py): "twister" (splats spiral up a vortex), "rain" (splats fall
and streak) and "spread" (a radial dissolve ring with glow), applied to an
activated splat dict once per video frame before it is rasterized.
"""

from typing import Dict, Optional, Tuple

import numpy as np


def _fract(x):
    return x - np.floor(x)


def smoothstep(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0 + 1e-12), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _hash3(p: np.ndarray) -> np.ndarray:
    """GLSL-style pseudo-random hash, (N, 3) -> (N, 3) in [0, 1)."""
    p = _fract(p * 0.3183099 + 0.1) * 17.0
    return np.stack([
        _fract(p[:, 0] * p[:, 1] * p[:, 2]),
        _fract(p[:, 0] + p[:, 1] * p[:, 2]),
        _fract(p[:, 0] * p[:, 1] + p[:, 2]),
    ], axis=1)


def _rot2d_apply(xz: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotate (N, 2) vectors by per-point angles (N,)."""
    c, s = np.cos(angle), np.sin(angle)
    return np.stack([c * xz[:, 0] - s * xz[:, 1],
                     s * xz[:, 0] + c * xz[:, 1]], axis=1)


def twister(means: np.ndarray, scales: np.ndarray, t: float
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Vortex effect (reference :138-147): small splats get pulled down/up a
    spiral whose phase grows with t; returns (new_means, strength s^4)."""
    h = _hash3(means)[:, 0:1] + 0.1
    l = np.linalg.norm(means[:, [0, 2]], axis=1)
    s = smoothstep(0.0, 8.0, t * t * 0.1 - l * 2.0 + 2.0)[:, None]
    small = np.linalg.norm(scales, axis=-1, keepdims=True) < 0.05
    y = np.where(small, (-10.0 + means[:, 1:2]) * (s ** (2 * h)), means[:, 1:2])
    xz = means[:, [0, 2]] * np.exp(-np.linalg.norm(means[:, [0, 2]], axis=1,
                                                   keepdims=True))
    xz = _rot2d_apply(xz, (t * 0.2 + means[:, 1] * 20.0 * (1 - s[:, 0])))
    out = np.concatenate([xz[:, 0:1], y, xz[:, 1:2]], axis=1)
    return out, (s ** 4)[:, 0]


def rain(means: np.ndarray, scales: np.ndarray, t: float
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Rain-dissolve (reference :149-160): splats drop toward y=-10 with a
    hash-jittered schedule; returns (new_means, alpha factor)."""
    h = _hash3(means)
    l = np.linalg.norm(means[:, [0, 2]], axis=1)
    s = smoothstep(0.0, 5.0, t * t * 0.1 - l * 2.0 + 1.0) ** (0.5 + h[:, 0])
    y0 = means[:, 1]
    y = np.minimum(-10.0 + s * 15.0, y0)
    x = means[:, 0] + y * 0.2
    ang = np.full(means.shape[0], t * 0.3)
    xz = _rot2d_apply(np.stack([x, means[:, 2]], 1), ang * 0)  # rotation of
    # ones in the reference is a global swirl approximated as identity here;
    # the visible motion comes from the fall term.
    out = np.stack([xz[:, 0], y, xz[:, 1]], axis=1)
    alpha = smoothstep(-10.0, y0, y)
    return out, alpha


def spread(splats: Dict[str, np.ndarray], t: float,
           rng: Optional[np.random.Generator] = None,
           ignore_scale: bool = False) -> Dict[str, np.ndarray]:
    """Radial dissolve ring (reference apply_effect effect_type=2):
    a ring at radius s sweeps outward; splats beyond it shrink to nothing,
    the ring itself glows, and an angular wipe reveals colors."""
    out = {k: np.array(v, copy=True) for k, v in splats.items()}
    means, scales = out["means"], out["scales"]
    s = smoothstep(0.0, 10.0, t - 3.2) * 10.0
    l = np.linalg.norm(means[:, [0, 2]], axis=1)

    border = np.abs(s - l - 0.5)
    decay = 1.0 - 0.2 * np.exp(-20.0 * border)
    local = means * decay[:, None]
    sv = smoothstep(s - 0.5, s, l + 0.5)
    if not ignore_scale:
        out["scales"] = scales * (1 - sv[:, None]) + 1e-9 * sv[:, None]
    out["means"] = local

    at = np.arctan2(local[:, 0], local[:, 2]) / 3.1416
    wipe = (at >= (t - 3.1416)).astype(np.float32)
    glow = np.exp(-20.0 * border) + np.exp(-50.0 * np.abs(t - at - 3.1416)) * 0.5
    if "colors" in out:
        out["colors"] = out["colors"] * wipe[:, None] + glow[:, None]
    out["opacities"] = out["opacities"] * wipe + glow

    rng = rng or np.random.default_rng(0)
    mask = rng.random(sv.shape) < sv * 0.8
    if not ignore_scale:
        out["means"][mask] = 0.0
        out["scales"][mask] = 0.0
        out["opacities"][mask] = 0.0
    return out


def apply_effect(splats: Dict[str, np.ndarray], t: float, effect: str,
                 rng: Optional[np.random.Generator] = None
                 ) -> Dict[str, np.ndarray]:
    """Apply a named effect at time t to an activated splat dict
    (means/quats/scales/opacities [+ colors or sh])."""
    if effect == "spread":
        return spread(splats, t, rng)
    out = {k: np.array(v, copy=True) for k, v in splats.items()}
    if effect == "twister":
        means, strength = twister(out["means"], out["scales"], t)
        out["means"] = means
        out["opacities"] = out["opacities"] * np.clip(1.0 - strength, 0.0, 1.0) \
            + out["opacities"] * strength
    elif effect == "rain":
        means, alpha = rain(out["means"], out["scales"], t)
        out["means"] = means
        out["opacities"] = out["opacities"] * alpha
    else:
        raise ValueError(f"unknown effect {effect!r} "
                         "(expected twister|rain|spread)")
    return out
