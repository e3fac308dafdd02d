"""TensorBoard event-file writer and readers, standard library only.

A copy of hunyuanworld_mirror_tpu/training/tb_writer.py (the port imports
nothing of the JAX package): TFRecord framing (length + masked CRC32C)
around hand-encoded `Event` protobufs, producing `events.out.tfevents.*`
files any TensorBoard reads; scalars and PNG images (a stdlib PNG encoder
and decoder); `read_scalars` and `read_images` parse a file back.

Usage:
    w = TBWriter("/tmp/logs/run1")
    w.scalars({"loss": 0.5, "lr": 1e-4}, step=10)
    w.close()
"""

import os
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; TFRecord uses the masked variant
# ---------------------------------------------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding for Event / Summary
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    # Summary { repeated Value = 1 }; Value { tag = 1 (string);
    # simple_value = 2 (float) } — each Value wraps as a field-1 submessage
    msg = _bytes(1, tag.encode()) + _f32(2, float(value))
    return _bytes(1, msg)


# ---------------------------------------------------------------------------
# PNG encoding (stdlib zlib only) + Summary.Image proto
# ---------------------------------------------------------------------------

def png_encode(arr) -> bytes:
    """(H, W) or (H, W, {1,2,3,4}) uint8 array -> PNG bytes (filter 0
    rows), the container built by hand like the TFRecord framing."""
    import zlib
    import numpy as np

    a = np.asarray(arr)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    assert c in (1, 2, 3, 4), f"bad channel count {c}"
    if c == 2:  # gray+alpha is legal PNG color type 4
        color_type = 4
    else:
        color_type = {1: 0, 3: 2, 4: 6}[c]
    a = np.ascontiguousarray(a, dtype=np.uint8)

    def chunk(typ: bytes, payload: bytes) -> bytes:
        raw = typ + payload
        return (struct.pack(">I", len(payload)) + raw
                + struct.pack(">I", zlib.crc32(raw) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 before each row
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def png_decode(data: bytes):
    """Decode a PNG produced by png_encode (8-bit, filter-0 rows only);
    not a general PNG reader."""
    import zlib
    import numpy as np

    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    i, idat, h = 8, b"", None
    while i < len(data):
        (ln,) = struct.unpack(">I", data[i:i + 4])
        typ = data[i + 4:i + 8]
        payload = data[i + 8:i + 8 + ln]
        if typ == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", payload[:10])
            assert depth == 8, "png_decode handles 8-bit only"
            c = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
        elif typ == b"IDAT":
            idat += payload
        i += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * c + 1
    rows = []
    for r in range(h):
        row = raw[r * stride:(r + 1) * stride]
        assert row[0] == 0, "png_decode handles filter 0 only"
        rows.append(np.frombuffer(row[1:], np.uint8).reshape(w, c))
    return np.stack(rows)


def _summary_image(tag: str, png: bytes, h: int, w: int, c: int) -> bytes:
    # Summary.Image { height = 1; width = 2; colorspace = 3;
    #                 encoded_image_string = 4 }; Value.image = field 4
    img = _int(1, h) + _int(2, w) + _int(3, c) + _bytes(4, png)
    msg = _bytes(1, tag.encode()) + _bytes(4, img)
    return _bytes(1, msg)


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           values: Optional[Dict[str, float]] = None) -> bytes:
    # Event { wall_time = 1 (double); step = 2 (int64);
    #         file_version = 3 (string); summary = 5 (Summary) }
    out = _f64(1, wall_time)
    if step is not None:
        out += _int(2, step)
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    if values:
        summary = b"".join(_summary_value(t, v) for t, v in values.items())
        out += _bytes(5, summary)
    return out


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class TBWriter:
    """Append-only scalar event writer (one events file per instance)."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{os.uname().nodename}.{os.getpid()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(time.time(),
                                     file_version="brain.Event:2")))
        self._f.flush()

    def scalars(self, metrics: Dict[str, float], step: int):
        vals = {k: float(v) for k, v in metrics.items()
                if isinstance(v, (int, float))}
        if vals:
            self._f.write(_record(_event(time.time(), step=step, values=vals)))

    def image(self, tag: str, array, step: int):
        """Log an image: (H, W[, C]) array; floats are scaled from [0, 1]."""
        import numpy as np

        a = np.asarray(array)
        if a.dtype != np.uint8:
            a = np.clip(np.nan_to_num(a) * 255.0, 0, 255).astype(np.uint8)
        if a.ndim == 2:
            a = a[:, :, None]
        png = png_encode(a)
        summary = _summary_image(tag, png, a.shape[0], a.shape[1], a.shape[2])
        event = (_f64(1, time.time()) + _int(2, step) + _bytes(5, summary))
        self._f.write(_record(event))
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.flush()
        self._f.close()


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def read_scalars(path: str):
    """Parse an events file back to [(step, {tag: value})], verifying CRCs."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "corrupt length crc"
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert dcrc == _masked_crc(data), "corrupt data crc"
            step, values = _parse_event(data)
            if values:
                out.append((step, values))
    return out


def _parse_event(data: bytes):
    i, step, values = 0, 0, {}

    def varint():
        nonlocal i
        shift = n = 0
        while True:
            b = data[i]
            i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    while i < len(data):
        tag = varint()
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v = varint()
            if field == 2:
                step = v
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 2:
            ln = varint()
            payload = data[i:i + ln]
            i += ln
            if field == 5:
                values.update(_parse_summary(payload))
    return step, values


def read_images(path: str):
    """Parse an events file back to [(step, tag, decoded_uint8_array)]."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            f.read(4)
            data = f.read(length)
            f.read(4)
            step, images = _parse_event_images(data)
            for tag, png in images:
                out.append((step, tag, png_decode(png)))
    return out


def _parse_event_images(data: bytes):
    i, step, images = 0, 0, []

    def varint(buf, j):
        shift = n = 0
        while True:
            b = buf[j]
            j += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n, j
            shift += 7

    while i < len(data):
        tag, i = varint(data, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = varint(data, i)
            if field == 2:
                step = v
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 2:
            ln, i = varint(data, i)
            summary = data[i:i + ln]
            i += ln
            if field != 5:
                continue
            j = 0
            while j < len(summary):
                t, j = varint(summary, j)
                if t & 7 != 2:
                    break
                ln2, j = varint(summary, j)
                val = summary[j:j + ln2]
                j += ln2
                if t >> 3 != 1:
                    continue
                k, name, img_msg = 0, None, None
                while k < len(val):
                    t2, k = varint(val, k)
                    f2, w2 = t2 >> 3, t2 & 7
                    if w2 == 2:
                        ln3, k = varint(val, k)
                        if f2 == 1:
                            name = val[k:k + ln3].decode()
                        elif f2 == 4:
                            img_msg = val[k:k + ln3]
                        k += ln3
                    elif w2 == 5:
                        k += 4
                    elif w2 == 1:
                        k += 8
                    elif w2 == 0:
                        _, k = varint(val, k)
                if name is not None and img_msg is not None:
                    m, png = 0, None
                    while m < len(img_msg):
                        t3, m = varint(img_msg, m)
                        if t3 & 7 == 2:
                            ln4, m = varint(img_msg, m)
                            if t3 >> 3 == 4:
                                png = img_msg[m:m + ln4]
                            m += ln4
                        elif t3 & 7 == 0:
                            _, m = varint(img_msg, m)
                    if png is not None:
                        images.append((name, png))
    return step, images


def _parse_summary(data: bytes):
    i, out = 0, {}

    def varint():
        nonlocal i
        shift = n = 0
        while True:
            b = data[i]
            i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    while i < len(data):
        tag = varint()
        field, wire = tag >> 3, tag & 7
        if wire != 2:
            break
        ln = varint()
        val = data[i:i + ln]
        i += ln
        if field == 1:  # Summary.Value
            j, name, num = 0, None, None
            while j < len(val):
                t = val[j]
                j += 1
                f2, w2 = t >> 3, t & 7
                if w2 == 2:
                    # proper varint length: image payloads exceed 127 bytes
                    ln2 = shift = 0
                    while True:
                        b2 = val[j]
                        j += 1
                        ln2 |= (b2 & 0x7F) << shift
                        if not b2 & 0x80:
                            break
                        shift += 7
                    if f2 == 1:
                        name = val[j:j + ln2].decode()
                    j += ln2
                elif w2 == 5:
                    if f2 == 2:
                        (num,) = struct.unpack("<f", val[j:j + 4])
                    j += 4
                elif w2 == 0:
                    while val[j] & 0x80:
                        j += 1
                    j += 1
                elif w2 == 1:
                    j += 8
            if name is not None and num is not None:
                out[name] = num
    return out
