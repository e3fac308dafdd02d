"""The multi-device dry run: one sharded training step over n ranks.

The twin of `__graft_entry__.dryrun_multichip` and its opt-in flagship pass
(`flagship_main` / `_dryrun_flagship`). n ranks are factored into a
(data, view, model) mesh as JAX factors n devices; the toy WorldMirror
(28 px, width 64, 2 + 2 trunk blocks, every head, the Gaussian render)
takes one step of the JAX loss under AdamW(1e-4) with its parameters
sharded over "model", its batch over "data" and its views over "view": the
global layers run ring attention, the render the distributed protocol
(ops/distributed.py). It prints JAX's lines: the collectives this rank
issued (`dryrun comm measured ...`, parallel/comm.stats, where JAX reads
the compiled HLO) and `dryrun_multichip ok: mesh=(d,v,m) loss=...`.

The flagship pass (`WM_FLAGSHIP=1` or `flagship=True`) takes one step of
the full-width model (ViT-L encoder, 24 + 24 blocks at width 1024, every
head, the render) at 112 px with bf16 parameters. JAX also lowers the
518 px program without running it; eager PyTorch has no such step, and the
pass says it skipped it.

    python -m hunyuanworld_mirror_tpu_torch.multichip --devices 4 --backend gloo

NCCL (the default) drives one card a rank and refuses more ranks than
cards; gloo runs every rank on the one device given, the collectives staged
through host memory (parallel/comm.py).
"""

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .models.worldmirror import WorldMirror, WorldMirrorConfig
from .parallel import comm, sharding
from .parallel import mesh as mesh_lib
from .training.trainer import AdamWCosine

TOY = dict(img_size=28, patch_size=14, embed_dim=64, gs_dim=32, patch_embed="conv",
           trunk_depth=2, trunk_heads=4, intermediate_idxs=(0, 0, 1, 1),
           enable_gs=True, enable_cond=True, rasterizer_impl="jax")
LR = 1e-4
WEIGHT_DECAY = 1e-4       # optax.adamw's default
FLAGSHIP_PX = 112


def dims_for(n: int):
    """JAX's factoring of n devices into (data, view, model)."""
    if n % 8 == 0:
        return (n // 8, 4, 2)
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0:
        return (n // 2, 2, 1)
    return (1, 1, 1)


def _mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of a mean over the global array: its sum over the
    global count (its shard times the data and view ranks)."""
    return x.float().sum() / (x.numel() * mesh.size("data") * mesh.size("view"))


def toy_loss(preds: Dict, img: torch.Tensor, mesh) -> Dict[str, torch.Tensor]:
    """__graft_entry__.dryrun_multichip's loss terms, this rank's share."""
    return {"depth": _mean(torch.abs(preds["depth"] - 1.0), mesh),
            "render": _mean((preds["rendered_colors"][..., :3] - img) ** 2, mesh),
            "pts3d": _mean(preds["pts3d"] ** 2, mesh) * 0.1,
            "camera": _mean(preds["camera_params"] ** 2, mesh) * 0.1,
            "normals": _mean(preds["normals"] ** 2, mesh) * 0.1}


def flagship_loss(preds: Dict, img: torch.Tensor, mesh) -> Dict[str, torch.Tensor]:
    """_dryrun_flagship's loss terms (no normals term), this rank's share."""
    return {"depth": _mean(torch.abs(preds["depth"] - 1.0), mesh),
            "render": _mean((preds["rendered_colors"] - img) ** 2, mesh),
            "pts3d": _mean(preds["pts3d"] ** 2, mesh) * 0.1,
            "camera": _mean(preds["camera_params"] ** 2, mesh) * 0.1}


def sync_grads(model: torch.nn.Module, mesh, bucket: int = 1 << 26) -> None:
    """Sum every gradient over the replicas of this rank's model shard
    (data and view), and the gradients of the parameters that see only
    this rank's heads (sharding.tp_partial_params) over the model group
    too. A parameter the loss missed here takes a zero gradient: another
    rank's may not be zero."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)

    def reduce(ps, group):
        by_dtype: Dict[torch.dtype, list] = {}
        for p in ps:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
        for group_ps in by_dtype.values():
            i = 0
            while i < len(group_ps):
                chunk, n = [], 0
                while i < len(group_ps) and (not chunk or n + group_ps[i].numel() <= bucket):
                    chunk.append(group_ps[i])
                    n += group_ps[i].numel()
                    i += 1
                flat = comm.reduce_raw(torch.cat([p.grad.reshape(-1) for p in chunk]), group)
                for p, g in zip(chunk, flat.split([p.numel() for p in chunk])):
                    p.grad.copy_(g.view_as(p))

    if mesh.group("replica") is not None:
        reduce(params, mesh.group("replica"))
    if mesh.group("model") is not None:
        reduce(sharding.tp_partial_params(model), mesh.group("model"))


def train_step(model: WorldMirror, opt: AdamWCosine, mesh, views: Dict, loss_fn,
               trunk_dtype=torch.bfloat16):
    """One step on this rank's shard of `views` -> (the global loss, its
    terms by name): the JAX loss over every rank's outputs, before the
    update. loss_fn gives this rank's share of each term."""
    opt.zero_grad()
    preds = model(views, render=True, trunk_dtype=trunk_dtype, mesh=mesh, grad=True)
    terms = loss_fn(preds, views["img"], mesh)
    sum(terms.values()).backward()
    sync_grads(model, mesh)
    parts = comm.all_reduce(torch.stack([t.detach() for t in terms.values()]),
                            mesh.group("replica")).tolist()
    opt.step()
    return sum(parts), dict(zip(terms, parts))


def dryrun_rank(rank: int, device, n: int, flagship: bool = False,
                trunk_dtype: str = "bfloat16", with_params: bool = False) -> Dict:
    """The dry run on one rank of an n-rank process group (mesh.spawn's
    worker) -> {"dims", "loss", "comm", "peak_gb"}, the whole state dict
    after the step under "params" where asked (rank 0), and the flagship
    pass's {"loss", "peak_gb", "comm"} under "flagship" where asked."""
    dims = dims_for(n)
    mesh = mesh_lib.make_mesh(*dims)
    d, v, _ = dims
    out = {"dims": dims}
    model = sharding.shard_model(WorldMirror(WorldMirrorConfig(**TOY), device=device,
                                             seed=0), mesh)
    B, S = max(2, 2 * d), max(4, v)
    views = sharding.shard_views(
        {"img": torch.full((B, S, 28, 28, 3), 0.5, device=device)}, mesh)
    opt = AdamWCosine(model, LR, None, WEIGHT_DECAY)
    comm.reset()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out["loss"], out["terms"] = train_step(model, opt, mesh, views, toy_loss,
                                           getattr(torch, trunk_dtype))
    out["comm"] = {k: dict(v) for k, v in comm.stats.items()}
    out["peak_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                      if device.type == "cuda" else None)
    if with_params:
        state = sharding.gather_state(model, mesh)
        if rank == 0:
            out["params"] = state
    del model, opt
    if flagship:
        out["flagship"] = flagship_rank(device, mesh)
    return out


def flagship_rank(device, mesh, px: int = FLAGSHIP_PX) -> Dict:
    """One fwd + bwd + AdamW step of the full-width model at `px` with bf16
    parameters on this rank's shard."""
    model = WorldMirror(WorldMirrorConfig(img_size=px, rasterizer_impl="jax"),
                        device=device, seed=1).to(torch.bfloat16)
    model = sharding.shard_model(model, mesh)
    B, S = 1, max(4, mesh.size("view"))
    views = sharding.shard_views(
        {"img": torch.full((B, S, px, px, 3), 0.5, device=device)}, mesh)
    opt = AdamWCosine(model, LR, None, WEIGHT_DECAY)
    comm.reset()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loss, terms = train_step(model, opt, mesh, views, flagship_loss)
    return {"loss": loss, "terms": terms, "comm": {k: dict(v) for k, v in comm.stats.items()},
            "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None)}


def dryrun_multichip(n: int, device=None, backend: Optional[str] = None,
                     flagship: Optional[bool] = None, trunk_dtype: str = "bfloat16",
                     with_params: bool = False, log=print) -> Dict:
    """Spawn n ranks, run the dry run, print JAX's lines -> rank 0's result
    (with every rank's loss under "losses")."""
    backend = backend or "nccl"
    if backend == "gloo":
        device = resolve_device(device)
    elif device is not None and torch.device(device).type != "cuda":
        raise ValueError("NCCL runs on CUDA devices; pass backend=\"gloo\" for "
                         f"{device}")
    if flagship is None:
        flagship = os.environ.get("WM_FLAGSHIP", "0") == "1"
    outs = mesh_lib.spawn(dryrun_rank, n, backend=backend, device=device,
                          args=(n, flagship, trunk_dtype, with_params))
    res = outs[0]
    res["losses"] = [o["loss"] for o in outs]
    d, v, m = res["dims"]
    loss = res["loss"]
    if not (np.isfinite(loss) and abs(loss) < 1e6):
        raise AssertionError(f"bad loss {loss}")
    log("dryrun comm measured (toy step, rank 0's collectives through the "
        f"{backend} process group): " + json.dumps(res["comm"]))
    log(f"dryrun_multichip ok: mesh=({d},{v},{m}) loss={loss:.4f} (incl. "
        "distributed-raster render loss; raster all_to_all in the comm dict above)")
    if not flagship:
        log("dryrun_flagship skipped: opt-in only (set WM_FLAGSHIP=1 or pass "
            "flagship=True)")
        return res
    fl = res["flagship"]
    if not (np.isfinite(fl["loss"]) and abs(fl["loss"]) < 1e6):
        raise AssertionError(f"bad flagship loss {fl['loss']}")
    log("dryrun_flagship comm measured (rank 0's collectives, incl. ring "
        "attention + raster all_to_all): " + json.dumps(fl["comm"]))
    peak = ("" if fl["peak_gb"] is None else
            f" peak {max(o['flagship']['peak_gb'] for o in outs):.2f} GB a rank")
    log(f"dryrun_flagship ok: ViT-L dims + GS + distributed raster + ring attention, "
        f"mesh=({d},{v},{m}) {FLAGSHIP_PX}px loss={fl['loss']:.4f}{peak}")
    log("dryrun_flagship 518px lower skipped: eager PyTorch has no separate "
        "lowering step to check")
    return res


def main(argv: Optional[Sequence[str]] = None, device=None,
         backend: Optional[str] = None, log=print) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: the CUDA cards visible)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="process-group backend (default nccl: one card a rank)")
    ap.add_argument("--flagship", action="store_true",
                    help="also run the full-width pass (or set WM_FLAGSHIP=1)")
    ap.add_argument("--trunk-dtype", choices=["bfloat16", "float32"],
                    default="bfloat16", help="the toy step's trunk dtype")
    args = ap.parse_args(argv)
    backend = args.backend or backend or "nccl"
    n = args.devices if args.devices is not None else torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no CUDA device is available; pass --devices and "
                           "backend=\"gloo\" with device=\"cpu\" to run on the CPU")
    return dryrun_multichip(n, device=device, backend=backend,
                            flagship=args.flagship or None,
                            trunk_dtype=args.trunk_dtype, log=log)


if __name__ == "__main__":
    main()
