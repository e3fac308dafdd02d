"""ctypes binding for the native (C++) sharded-tar streamer.

Port of hunyuanworld_mirror_tpu/training/native_loader.py over the same
source, native/tar_reader.cpp: a pthread pool reads shards sequentially,
walks their ustar headers and groups files into samples behind a bounded
queue, in the training process (no worker processes, no pickling).

The library is built from the source at first use with g++ into
`build/native/` at the repository root (its file name carries a hash of the
source), never into `native/`. `available()` is False where it does not
build; ShardedLoader(use_native="auto") then reads the shards with tarfile.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "tar_reader.cpp"
BUILD_DIR = _ROOT / "build" / "native"

_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libwmtar-{digest}.so"


def build() -> Path:
    """Compile native/tar_reader.cpp unless a build of this source exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native loader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
                        str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building the native loader failed:\n{r.stderr}")
    os.replace(tmp, out)
    return out


def available() -> bool:
    """True when the library builds (or is built) and loads."""
    return _load() is not None


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        _build_error = str(e)
        return None
    lib.wmtar_open.restype = ctypes.c_void_p
    lib.wmtar_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                               ctypes.c_int, ctypes.c_int]
    lib.wmtar_next.restype = ctypes.c_void_p
    lib.wmtar_next.argtypes = [ctypes.c_void_p]
    lib.wmtar_sample_key.restype = ctypes.c_char_p
    lib.wmtar_sample_key.argtypes = [ctypes.c_void_p]
    lib.wmtar_sample_nparts.restype = ctypes.c_int
    lib.wmtar_sample_nparts.argtypes = [ctypes.c_void_p]
    lib.wmtar_sample_part_name.restype = ctypes.c_char_p
    lib.wmtar_sample_part_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wmtar_sample_part_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.wmtar_sample_part_data.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int64)]
    lib.wmtar_sample_free.argtypes = [ctypes.c_void_p]
    lib.wmtar_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def iter_shards_native(shards: Sequence[str], n_threads: int = 3,
                       queue_cap: int = 128) -> Iterator[Dict[str, bytes]]:
    """Stream webdataset-style samples ({suffix: bytes, '__key__': str})
    from tar shards through the native thread pool."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native loader is unavailable: {_build_error}")
    arr = (ctypes.c_char_p * len(shards))(*[s.encode() for s in shards])
    handle = lib.wmtar_open(arr, len(shards), n_threads, queue_cap)
    try:
        while True:
            s = lib.wmtar_next(handle)
            if not s:
                break
            out = {"__key__": lib.wmtar_sample_key(s).decode()}
            for i in range(lib.wmtar_sample_nparts(s)):
                name = lib.wmtar_sample_part_name(s, i).decode()
                size = ctypes.c_int64()
                ptr = lib.wmtar_sample_part_data(s, i, ctypes.byref(size))
                out[name] = ctypes.string_at(ptr, size.value)
            lib.wmtar_sample_free(s)
            yield out
    finally:
        lib.wmtar_close(handle)
