"""The mesh's collectives as autograd Functions, with JAX's transposes.

The JAX package writes its multi-device code with `lax.all_gather`,
`lax.all_to_all`, `lax.ppermute` and `lax.psum` inside shard_map and lets
autodiff transpose them. Here each is a torch.autograd.Function whose
backward is that transpose:

  all_gather(x, group, dim)        tiled gather along `dim`; backward: the
                                   cotangent summed over the group, this
                                   rank's part taken
  all_to_all(x, group, s, c)       split `s` over the ranks, concatenate the
                                   received parts along `c` (tiled=True);
                                   backward: the inverse all_to_all
  ppermute(x, group, shift)        to the rank `shift` further on the ring;
                                   backward: to the rank `shift` back
  all_reduce(x, group)             sum; backward: the identity
  copy_to_tp(x, group)             Megatron's f: identity, backward a sum
  reduce_from_tp(x, group)         Megatron's g: a sum, backward identity

A group of one rank (None) makes each of them the identity. On a gloo group
a CUDA tensor is copied to pinned host memory, moved, and copied back (gloo
moves CUDA tensors for few collectives); on an NCCL group tensors go as they
are. The backend is the group's own and is never switched. The all-to-all
is pairwise sends and receives on every backend (some builds' gloo has no
all-to-all).

`stats` counts every collective issued on this rank under the JAX names
(`all-gather`, `all-reduce`, `all-to-all`, `collective-permute`): calls,
the bytes of its output on this rank (what __graft_entry__._collective_bytes
reads off the compiled HLO), and apart from them the bytes copied between
the device and the host for gloo. `reset()` zeroes it.
"""

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

stats: Dict[str, Dict[str, int]] = {}


def reset() -> None:
    stats.clear()


def _record(name: str, out_bytes: int, staged_bytes: int) -> None:
    rec = stats.setdefault(name, {"count": 0, "bytes": 0, "staged_bytes": 0})
    rec["count"] += 1
    rec["bytes"] += out_bytes
    rec["staged_bytes"] += staged_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


class _Stage:
    """Where a collective's tensors live: a CUDA tensor on a gloo group goes
    through pinned host memory; the bytes moved are counted."""

    def __init__(self, group, like: torch.Tensor):
        self.device = like.device
        self.host = (like.device.type == "cuda"
                     and dist.get_backend(group) == dist.Backend.GLOO)
        self.moved = 0

    def put(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if not self.host:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.moved += _nbytes(t)
        return h

    def empty(self, shape, dtype) -> torch.Tensor:
        if self.host:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def get(self, t: torch.Tensor) -> torch.Tensor:
        if not self.host:
            return t
        self.moved += _nbytes(t)
        return t.to(self.device)


def gather_raw(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The tiled all-gather, outside autograd."""
    st = _Stage(group, x)
    xs = st.put(x)
    parts = [st.empty(xs.shape, xs.dtype) for _ in range(_size(group))]
    dist.all_gather(parts, xs, group=group)
    out = st.get(torch.cat(parts, dim=dim))
    _record("all-gather", _nbytes(out), st.moved)
    return out


def reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    """The all-reduce sum into a new tensor, outside autograd."""
    st = _Stage(group, x)
    xs = st.put(x)
    if xs is x:
        xs = x.clone()
    dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=group)
    out = st.get(xs)
    _record("all-reduce", _nbytes(out), st.moved)
    return out


def all_to_all_raw(x: torch.Tensor, group, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    n = _size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} is not a "
                         f"multiple of the group's {n} ranks")
    ranks: List[int] = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    st = _Stage(group, x)
    ins = [st.put(c) for c in x.chunk(n, dim=split_dim)]
    outs = [c if i == me else st.empty(c.shape, c.dtype) for i, c in enumerate(ins)]
    ops = []
    for i, peer in enumerate(ranks):
        if i != me:
            ops += [dist.P2POp(dist.isend, ins[i], peer, group),
                    dist.P2POp(dist.irecv, outs[i], peer, group)]
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    out = st.get(torch.cat(outs, dim=concat_dim))
    _record("all-to-all", _nbytes(out), st.moved)
    return out


def ppermute_raw(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send x to the rank `shift` further on the group's ring and receive
    from the rank `shift` back."""
    ranks: List[int] = dist.get_process_group_ranks(group)
    i = ranks.index(dist.get_rank())
    dst, src = ranks[(i + shift) % len(ranks)], ranks[(i - shift) % len(ranks)]
    st = _Stage(group, x)
    xs = st.put(x)
    out = st.empty(xs.shape, xs.dtype)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, xs, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    out = st.get(out)
    _record("collective-permute", _nbytes(out), st.moved)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return gather_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        full = reduce_raw(g, ctx.group)
        return full.narrow(ctx.dim, _rank(ctx.group) * ctx.n, ctx.n), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return all_to_all_raw(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (all_to_all_raw(g, ctx.group, ctx.concat_dim, ctx.split_dim),
                None, None, None)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ppermute_raw(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ppermute_raw(g, ctx.group, -ctx.shift), None, None


class _Sum(torch.autograd.Function):
    """all_reduce and reduce_from_tp: a sum forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_raw(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if _size(group) == 1 else _AllGather.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    if _size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    return x if _size(group) == 1 else _Permute.apply(x, group, shift)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _Sum.apply(x, group)


def copy_to_tp(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyToTP.apply(x, group)


reduce_from_tp = all_reduce
