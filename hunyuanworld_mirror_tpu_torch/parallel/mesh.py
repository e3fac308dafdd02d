"""The (data, view, model) mesh as torch.distributed process groups.

Port of hunyuanworld_mirror_tpu/parallel/mesh.py. The axes are the JAX
package's:
  * "data": the batch is sharded (data parallelism);
  * "view": the S views are sharded (sequence parallelism): frame attention
    stays on a rank's own frames, the global layers run ring attention over
    this axis, the splats of the render are sharded over it;
  * "model": tensor parallelism over attention heads and the MLP hidden
    width (parallel/sharding.py).

Rank r sits at the coordinates of `np.arange(n).reshape(data, view, model)`,
as JAX lays its devices out, and holds one process group per axis of size
> 1 (the ranks that differ from it along that axis only) and one over data
and view together (the replicas of its model shard, over which gradients
are summed). The view group is also a ring: `ring_next` / `ring_prev`.

`spawn` starts n ranks with torch.multiprocessing on a `file://` store:
under NCCL rank r drives `cuda:{r}` (one card a rank); under gloo every rank
drives the one device the caller names, and the collectives stage CUDA
tensors through host memory (parallel/comm.py).
"""

import os
import pickle
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "view", "model")


@dataclass
class Mesh:
    dims: Tuple[int, int, int]
    rank: int
    coords: Tuple[int, int, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    ring: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as JAX's Mesh.shape."""
        return dict(zip(AXES, self.dims))

    def size(self, axis: str) -> int:
        return self.dims[AXES.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.coords[AXES.index(axis)]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group along `axis` ("data", "view", "model", or
        "replica": data and view together); None where it has one rank."""
        return self.groups[axis]

    @property
    def ring_next(self) -> int:
        """The global rank after this one on the view ring."""
        i = self.ring.index(self.rank)
        return self.ring[(i + 1) % len(self.ring)]

    @property
    def ring_prev(self) -> int:
        i = self.ring.index(self.rank)
        return self.ring[(i - 1) % len(self.ring)]


def _axis_members(grid: np.ndarray, axes: Sequence[int]):
    """Every set of ranks that differ only along `axes` of the rank grid."""
    keep = [a for a in range(3) if a not in axes]
    moved = np.moveaxis(grid, keep + list(axes), list(range(3)))
    flat = moved.reshape(int(np.prod([grid.shape[a] for a in keep])), -1)
    return [tuple(int(r) for r in row) for row in flat]


def make_mesh(data: int = 1, view: int = 1, model: int = 1) -> Mesh:
    """The mesh over the ranks of the default process group. Its world size
    must equal data * view * model; a mesh of one rank needs no process
    group. Every rank must call this (dist.new_group is collective)."""
    n = data * view * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"mesh ({data}, {view}, {model}) needs {n} ranks, the "
                         f"process group has {world}")
    grid = np.arange(n).reshape(data, view, model)
    coords = tuple(int(c) for c in np.argwhere(grid == rank)[0])
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    ring: Tuple[int, ...] = (rank,)
    for name, axes in (("data", (0,)), ("view", (1,)), ("model", (2,)),
                       ("replica", (0, 1))):
        groups[name] = None
        if int(np.prod([grid.shape[a] for a in axes])) == 1:
            continue
        for members in _axis_members(grid, axes):
            g = dist.new_group(list(members))
            if rank in members:
                groups[name] = g
                if name == "view":
                    ring = members
    return Mesh((data, view, model), rank, coords, groups, ring)


def auto_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The JAX package's heuristic: the largest view axis of 8, 4, 2, 1 that
    divides n, the rest to data."""
    n = n_devices if n_devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    view = next(c for c in (8, 4, 2, 1) if n % c == 0)
    return make_mesh(data=n // view, view=view, model=1)


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _child(rank: int, n: int, backend: str, device: str, store: str,
           fn: Callable, args: tuple, queue, timeout_s: float) -> None:
    torch.set_num_threads(1)
    dev = torch.device(f"cuda:{rank}" if backend == "nccl" else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n,
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, dev, *args)
        torch.set_num_threads(1)
        # plain pickle: the tensors' bytes travel in the message, not as
        # shared memory that dies with this process
        queue.put((rank, pickle.dumps(_to_host(out))))
    finally:
        dist.destroy_process_group()


def check_backend(n: int, backend: str) -> None:
    """NCCL drives one card a rank: more ranks than cards is refused."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    cards = torch.cuda.device_count()
    if backend == "nccl" and n > cards:
        raise ValueError(
            f"NCCL needs one card a rank: {n} ranks, {cards} card(s) visible. "
            "Pass backend=\"gloo\" to run the ranks on one device, the "
            "collectives staged through host memory")


def spawn(fn: Callable, n: int, backend: str = "nccl", device=None,
          args: tuple = (), timeout_s: float = 900.0) -> list:
    """Run fn(rank, device, *args) in n new processes joined in one process
    group (`backend` on a file:// store) -> the n return values by rank,
    tensors moved to the CPU. Under NCCL rank r gets cuda:{r}; under gloo
    every rank gets `device` (CUDA unless named; without a GPU, None
    raises). `fn` must be importable by name (a module-level function).
    Every child has one intra-op thread. A child that raises ends the others
    and the error comes back here."""
    check_backend(n, backend)
    if backend == "gloo":
        from .. import resolve_device
        device = str(resolve_device(device))
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    got: Dict[int, object] = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = torch.multiprocessing.start_processes(
            _child, args=(n, backend, device, os.path.join(tmp, "store"), fn, args,
                          queue, timeout_s),
            nprocs=n, join=False, start_method="spawn")
        # read while the children run: a result larger than the pipe's
        # buffer holds its child until it is read
        while True:
            while not queue.empty():
                rank, out = queue.get()
                got[rank] = pickle.loads(out)
            if procs.join(timeout=0.05):
                break
        while not queue.empty():
            rank, out = queue.get()
            got[rank] = pickle.loads(out)
    missing = sorted(set(range(n)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} ended without a result")
    return [got[r] for r in range(n)]
