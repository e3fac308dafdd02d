"""Ring attention over the view-sharded token axis.

Port of hunyuanworld_mirror_tpu/parallel/ring.py. Each rank holds the
tokens of its own views (its q, k, v: (B, N_local, H, D)); the K/V shards
go round the view ring (comm.ppermute, to the next rank after every step
but the last) while each rank accumulates an online softmax of its queries
over every shard: the running row max, the denominator and the numerator in
f32, the per-step logits in the input dtype. The math is JAX's line for
line, so autograd through the ppermutes gives the gradient JAX's autodiff
does.

This is a plain product in JAX too (einsum, outside any Pallas kernel), so
it is plain PyTorch here: a mesh puts the global layers on this path and
off kernel K1, as `models/block.py` does in JAX.
"""

import torch

from . import comm


def _dense(q, k, v, scale: float) -> torch.Tensor:
    """JAX's branch for a view axis of one: einsum, an f32 softmax rounded
    to the input dtype, einsum."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", w, v)


def _ring_attention_local(q, k, v, group, scale: float) -> torch.Tensor:
    """q, k, v: (B, N_local, H, D) of this rank -> its (B, N_local, H, D)
    output, attending to the keys of every rank of `group`."""
    n = torch.distributed.get_world_size(group)
    B, Nl, H, D = q.shape
    qs = q * scale
    m = torch.full((B, Nl, H, 1), -float("inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Nl, H, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Nl, H, D), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        logits = torch.einsum("bnhd,bmhd->bhnm", qs, k_cur).float()
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True).transpose(1, 2))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new.transpose(1, 2))                # (B, H, Nl, Nl)
        l = l * corr + p.sum(-1, keepdim=True).transpose(1, 2)
        pv = torch.einsum("bhnm,bmhd->bnhd", p.to(v_cur.dtype), v_cur)
        acc = acc * corr + pv.float()
        m = m_new
        if step + 1 < n:
            k_cur = comm.ppermute(k_cur, group, 1)
            v_cur = comm.ppermute(v_cur, group, 1)
    return (acc / l).to(q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh, scale: float, seq_axis: str = "view") -> torch.Tensor:
    """Unmasked self-attention over the tokens of every rank of the mesh's
    `seq_axis`; q, k, v and the output are this rank's (B, N_local, H, D)
    (its batch shard over "data", its heads over "model"). With one rank
    on the axis, or no mesh, it is JAX's dense branch."""
    if mesh is None or mesh.size(seq_axis) == 1:
        return _dense(q, k, v, scale)
    return _ring_attention_local(q, k, v, mesh.group(seq_axis), scale)
