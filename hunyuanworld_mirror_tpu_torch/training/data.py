"""Sharded-tar streaming data pipeline (WebDataset layout).

Port of hunyuanworld_mirror_tpu/training/data.py: shard glob or brace
range -> an epoch-seeded shard shuffle -> worker split -> tar ->
samples grouped by key -> decode (color.png, depth.exr clamped to 25 m,
meta.json, heatmap.npz, pose_map.npz) -> a shuffle buffer -> batches, on a
background prefetch thread. The shuffles draw from Python's `random` in the
JAX package's order, so one seed gives the same batches in both packages.

One departure. The JAX loader skips any sample whose decode raises, a
missing decoder included; where PIL or cv2 is absent every sample would
then be skipped and training would end after no step. Here a sample that
needs a decoder this machine lacks raises DecoderUnavailable, which is
never skipped. color.png is read by PIL where it is installed, else by
`read_png` (numpy + zlib: 8-bit, non-interlaced RGB or RGBA, filters 0-4);
depth.exr needs cv2.
"""

import glob as globlib
import io
import json
import queue
import random
import struct
import tarfile
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class DecoderUnavailable(RuntimeError):
    """A sample needs a decoder that this machine does not have."""


def expand_shards(pattern) -> List[str]:
    """Accept a glob, brace-range 'shard-{000..012}.tar', list, or dir."""
    if isinstance(pattern, (list, tuple)):
        out = []
        for p in pattern:
            out.extend(expand_shards(p))
        return sorted(set(out))
    if "{" in pattern and ".." in pattern:
        head, rest = pattern.split("{", 1)
        rng, tail = rest.split("}", 1)
        lo, hi = rng.split("..")
        width = len(lo)
        return [f"{head}{i:0{width}d}{tail}" for i in range(int(lo), int(hi) + 1)]
    hits = sorted(globlib.glob(pattern))
    return hits if hits else [pattern]


def iter_tar_samples(shard_path: str) -> Iterator[Dict[str, bytes]]:
    """Group tar members by basename key: {key, ext: bytes, ...}."""
    with tarfile.open(shard_path, "r|*") as tf:
        current_key, sample = None, {}
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            if "." not in name:
                continue
            key, ext = name.split(".", 1)
            if current_key is not None and key != current_key:
                if sample:
                    sample["__key__"] = current_key
                    yield sample
                sample = {}
            current_key = key
            sample[ext] = tf.extractfile(member).read()
        if sample:
            sample["__key__"] = current_key
            yield sample


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one PNG scanline filter (uint8 arithmetic, modulo 256)."""
    if ftype == 0:
        return row
    if ftype == 2:
        return row + prev
    if ftype == 1:   # Sub: a running sum along each channel
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        elif ftype == 4:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 from an 8-bit, non-interlaced RGB or RGBA PNG (the
    alpha dropped, as PIL's convert("RGB") drops it). A PNG of another kind
    raises DecoderUnavailable; bytes that are no PNG raise ValueError."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    i, idat, hdr = 8, [], None
    while i + 8 <= len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        typ, payload = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if typ == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload[:13])
        elif typ == b"IDAT":
            idat.append(payload)
        elif typ == b"IEND":
            break
        i += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = hdr
    if depth != 8 or color_type not in (2, 6) or interlace != 0:
        raise DecoderUnavailable(
            f"PNG of bit depth {depth}, colour type {color_type}, interlace "
            f"{interlace}: the numpy reader takes 8-bit non-interlaced RGB or "
            "RGBA; install PIL for others")
    bpp = 3 if color_type == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * bpp + 1
    if raw.size < h * stride:
        raise ValueError("truncated PNG data")
    rows = raw[:h * stride].reshape(h, stride)
    out = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for r in range(h):
        prev = out[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:], prev, bpp)
    return out.reshape(h, w, bpp)[..., :3]


def decode_image_bytes(data: bytes) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        return read_png(data).astype(np.float32) / 255.0
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def decode_exr_bytes(data: bytes) -> Optional[np.ndarray]:
    try:
        import cv2
    except ImportError as e:
        raise DecoderUnavailable("depth.exr needs cv2, which is not installed") from e
    arr = np.frombuffer(data, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32)


def decode_npz_bytes(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def decode_sope_sample(sample: Dict[str, bytes],
                       max_depth: float = 25.0) -> Optional[Dict[str, np.ndarray]]:
    """SOPE sample: color.png + depth.exr + meta.json + heatmap/pose_map npz.
    A corrupt sample is skipped (None, with a warning); a missing decoder
    raises."""
    try:
        out = {"__key__": sample.get("__key__", "")}
        out["rgb"] = decode_image_bytes(sample["color.png"])
        if "depth.exr" in sample:
            depth = decode_exr_bytes(sample["depth.exr"])
            if depth is None:
                return None
            out["depth"] = np.clip(depth, 0.0, max_depth)
        if "meta.json" in sample:
            out["meta"] = json.loads(sample["meta.json"].decode())
        if "heatmap.npz" in sample:
            hm = decode_npz_bytes(sample["heatmap.npz"])
            out["heatmap"] = next(iter(hm.values())).astype(np.float32)
        if "pose_map.npz" in sample:
            pm = decode_npz_bytes(sample["pose_map.npz"])
            out["pose_map"] = next(iter(pm.values())).astype(np.float32)
        return out
    except DecoderUnavailable:
        raise
    except Exception as e:
        print(f"warning: skipping corrupt sample: {type(e).__name__}: {e}")
        return None


class ShardedLoader:
    """Epoch-seeded shard shuffle -> streamed decode -> shuffle buffer -> batch."""

    def __init__(self, shards, batch_size: int = 20, shuffle_buffer: int = 2000,
                 seed: int = 0, decode_fn=decode_sope_sample,
                 worker_index: int = 0, num_workers: int = 1,
                 prefetch: int = 4, drop_keys: Sequence[str] = ("meta", "__key__"),
                 use_native: str = "auto", native_threads: int = 3):
        """use_native: "auto" takes the C++ tar streamer
        (training/native_loader.py) when it builds, "never"/"always" force
        a path."""
        self.shards = expand_shards(shards)
        self.batch_size = batch_size
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.decode_fn = decode_fn
        self.worker_index = worker_index
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_keys = set(drop_keys)
        self.native_threads = native_threads
        if use_native == "always":
            self.use_native = True
        elif use_native == "never":
            self.use_native = False
        else:
            from . import native_loader
            self.use_native = native_loader.available()

    def _raw_samples(self, shards: List[str]) -> Iterator[Dict[str, bytes]]:
        if self.use_native:
            from . import native_loader
            yield from native_loader.iter_shards_native(
                shards, n_threads=self.native_threads)
        else:
            for shard in shards:
                yield from iter_tar_samples(shard)

    def _samples(self, epoch: int) -> Iterator[Dict]:
        rng = random.Random(self.seed + epoch)
        shards = list(self.shards)
        rng.shuffle(shards)
        shards = shards[self.worker_index::self.num_workers]
        buf: List[Dict] = []
        for raw in self._raw_samples(shards):
            dec = self.decode_fn(raw)
            if dec is None:
                continue
            buf.append(dec)
            if len(buf) >= self.shuffle_buffer:
                idx = rng.randrange(len(buf))
                yield buf.pop(idx)
        rng.shuffle(buf)
        yield from buf

    def _batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        batch: List[Dict] = []
        for s in self._samples(epoch):
            batch.append(s)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []

    def _collate(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        keys = [k for k in batch[0] if k not in self.drop_keys]
        return {k: np.stack([b[k] for b in batch]) for k in keys}

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate one epoch with a background prefetch thread; an error in
        the producer (a missing decoder) is raised here."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        failure = []

        def producer():
            try:
                for b in self._batches(epoch):
                    q.put(b)
            except Exception as e:   # raised again by the consumer below
                failure.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        if failure:
            raise failure[0]
