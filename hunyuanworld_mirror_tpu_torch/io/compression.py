"""Splat compression: quantized-PNG grids and a k-means SH codebook.

A copy of hunyuanworld_mirror_tpu/io/compression.py (the port imports
nothing of the JAX package), writing the same PNGs and meta.json byte for
byte and npz files with the same arrays (a zip entry carries its time): splats
are cropped to a square count (the lowest opacities dropped), sorted along
a Morton curve of their quantized means, and each attribute becomes a
min-max-quantized PNG (means: log-transformed, 16 bits as two 8-bit
images; scales, quats, opacities, sh0: 8 bits), the higher SH bands a
k-means codebook, anything else an npz, with the ranges in meta.json.
PNGs are written and read by PIL, whose encoder the JAX package reaches
through imageio with the same settings.
"""

import json
import os
from typing import Dict, Tuple

import numpy as np


def log_transform(x: np.ndarray) -> np.ndarray:
    return np.sign(x) * np.log1p(np.abs(x))


def inverse_log_transform(y: np.ndarray) -> np.ndarray:
    return np.sign(y) * np.expm1(np.abs(y))


def _morton_order(means: np.ndarray, bits: int = 16) -> np.ndarray:
    """Sort order interleaving the bits of quantized xyz (z-order curve)."""
    mn, mx = means.min(0), means.max(0)
    q = ((means - mn) / np.maximum(mx - mn, 1e-12) * (2 ** bits - 1)).astype(np.uint64)
    code = np.zeros(len(means), np.uint64)
    for b in range(bits):
        for d in range(3):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + d)
    return np.argsort(code, kind="stable")


def _quantize(x: np.ndarray, bits: int) -> Tuple[np.ndarray, Dict]:
    mins = x.min(axis=0)
    maxs = x.max(axis=0)
    scale = np.maximum(maxs - mins, 1e-12)
    q = np.round((x - mins) / scale * (2 ** bits - 1))
    dtype = np.uint8 if bits == 8 else np.uint16
    return q.astype(dtype), {"mins": mins.tolist(), "maxs": maxs.tolist()}


def _dequantize(q: np.ndarray, meta: Dict, bits: int) -> np.ndarray:
    mins = np.asarray(meta["mins"], np.float32)
    maxs = np.asarray(meta["maxs"], np.float32)
    return q.astype(np.float32) / (2 ** bits - 1) * np.maximum(maxs - mins, 1e-12) + mins


def _write_png(path: str, img: np.ndarray):
    from PIL import Image
    Image.fromarray(img).save(path, format="PNG")


def _read_png(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def _kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0):
    """Tiny Lloyd's k-means: (N, D) -> (codebook (k, D), labels (N,))."""
    rng = np.random.default_rng(seed)
    k = min(k, len(x))
    centers = x[rng.choice(len(x), k, replace=False)].copy()
    labels = np.zeros(len(x), np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1) if len(x) * k < 5e7 \
            else None
        if d is None:  # chunked distance for big N
            labels = np.concatenate([
                ((x[i:i + 65536, None, :] - centers[None]) ** 2).sum(-1).argmin(1)
                for i in range(0, len(x), 65536)])
        else:
            labels = d.argmin(1)
        for j in range(k):
            m = labels == j
            if m.any():
                centers[j] = x[m].mean(0)
    return centers, labels


def compress(compress_dir: str, splats: Dict[str, np.ndarray],
             use_sort: bool = True, sh_clusters: int = 256) -> Dict:
    """Compress a splat dict. Expected keys: means, scales, quats, opacities,
    and either sh (N, K, 3) or sh0/shN; extra keys go to npz. Pre-activation
    values (log scales / logit opacities) compress best but any floats work.
    Drops the lowest-opacity splats down to a square count (reference :26)."""
    os.makedirs(compress_dir, exist_ok=True)
    splats = dict(splats)
    if "sh" in splats:
        sh = splats.pop("sh")
        splats["sh0"] = sh[:, 0]
        if sh.shape[1] > 1:
            splats["shN"] = sh[:, 1:].reshape(len(sh), -1)

    n = len(splats["means"])
    side = int(n ** 0.5)
    crop = n - side * side
    if crop:
        keep = np.argsort(splats["opacities"].reshape(n, -1)[:, 0])[crop:]
        splats = {k: v[keep] for k, v in splats.items()}
    if use_sort:
        order = _morton_order(np.asarray(splats["means"], np.float32))
        splats = {k: v[order] for k, v in splats.items()}

    meta = {"n_sidelen": side, "count": side * side}
    for name, val in splats.items():
        val = np.asarray(val, np.float32)
        entry = {"shape": list(val.shape)}
        if name == "means":
            q, rng = _quantize(log_transform(val), 16)
            _write_png(os.path.join(compress_dir, "means_l.png"),
                       (q & 0xFF).astype(np.uint8).reshape(side, side, -1))
            _write_png(os.path.join(compress_dir, "means_u.png"),
                       (q >> 8).astype(np.uint8).reshape(side, side, -1))
            entry.update(rng, encoding="png16_log")
        elif name in ("scales", "quats", "opacities", "sh0"):
            v2 = val.reshape(len(val), -1)
            q, rng = _quantize(v2, 8)
            _write_png(os.path.join(compress_dir, f"{name}.png"),
                       q.reshape(side, side, -1).squeeze())
            entry.update(rng, encoding="png8")
        elif name == "shN":
            centers, labels = _kmeans(val, sh_clusters)
            q, rng = _quantize(centers, 8)
            np.savez_compressed(os.path.join(compress_dir, "shN.npz"),
                                codebook=q, labels=labels.astype(np.uint16))
            entry.update(rng, encoding="kmeans", clusters=int(len(centers)))
        else:
            np.savez_compressed(os.path.join(compress_dir, f"{name}.npz"),
                                arr=val)
            entry.update(encoding="npz")
        meta[name] = entry
    with open(os.path.join(compress_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def decompress(compress_dir: str) -> Dict[str, np.ndarray]:
    with open(os.path.join(compress_dir, "meta.json")) as f:
        meta = json.load(f)
    side = meta["n_sidelen"]
    out = {}
    for name, entry in meta.items():
        if not isinstance(entry, dict):
            continue
        shape = entry["shape"]
        if entry["encoding"] == "png16_log":
            lo = _read_png(os.path.join(compress_dir, "means_l.png"))
            hi = _read_png(os.path.join(compress_dir, "means_u.png"))
            q = (hi.astype(np.uint16) << 8) | lo.astype(np.uint16)
            out[name] = inverse_log_transform(
                _dequantize(q.reshape(side * side, -1), entry, 16)).reshape(shape)
        elif entry["encoding"] == "png8":
            q = _read_png(os.path.join(compress_dir, f"{name}.png"))
            out[name] = _dequantize(q.reshape(side * side, -1), entry,
                                    8).reshape(shape)
        elif entry["encoding"] == "kmeans":
            z = np.load(os.path.join(compress_dir, "shN.npz"))
            centers = _dequantize(z["codebook"], entry, 8)
            out[name] = centers[z["labels"]].reshape(shape)
        else:
            out[name] = np.load(os.path.join(compress_dir, f"{name}.npz"))["arr"]
    if "sh0" in out:
        sh0 = out.pop("sh0")[:, None, :]
        if "shN" in out:
            shN = out.pop("shN").reshape(len(sh0), -1, 3)
            out["sh"] = np.concatenate([sh0, shN], axis=1)
        else:
            out["sh"] = sh0
    return out
