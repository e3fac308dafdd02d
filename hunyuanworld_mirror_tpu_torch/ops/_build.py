"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: a build takes seconds,
not minutes). The build happens at first use into `build/kernels/` at the
repository root; the library's file name carries a hash of its source and of
the csrc headers it includes, so an edited kernel or header is never served
from a stale build. Nothing here runs at import time: this module is
imported on machines without nvcc or a card.

`load` builds one source at a time. Building several at once, and keeping
nvcc's -Xptxas -v report (register and spill counts), is there for
chip_smoke.py, which starts every kernel's nvcc together and prints the
report; the report also carries nvcc's errors when a build fails.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCAL_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def _sources(name: str) -> List[Path]:
    """csrc/<name>.cu and every csrc header it includes, directly or not."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / h.decode() for h in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    """The library's file name hashes its source and the headers it
    includes, so an edit to either is never served from a stale build."""
    digest = hashlib.sha256()
    for path in _sources(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named sources that have no current library, all nvcc
    processes at once; returns each one's wall seconds (0 if already built).
    nvcc's -Xptxas -v report goes to build/kernels/<name>.ptxas.txt."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.ptxas.txt", "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log, time.time())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.time() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        report = "\n".join((BUILD_DIR / f"{n}.ptxas.txt").read_text()
                           for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{report}")
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
