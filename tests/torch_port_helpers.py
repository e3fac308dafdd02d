"""Shared helpers for the PyTorch/CUDA port's CPU tests (test_torch_port_*).

Each test feeds the same numpy inputs, made from a seed, through the JAX
function (on the CPU, as the rest of the suite runs it) and through its
counterpart in hunyuanworld_mirror_tpu_torch with device="cpu", where every
kernel wrapper takes its plain PyTorch version.
"""

import numpy as np
import torch

# six xdist workers share the machine: keep each one's intra-op pool small
torch.set_num_threads(2)


def uniform(seed: int, shape, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def t(a) -> torch.Tensor:
    """numpy -> f32 CPU tensor."""
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def np_(x) -> np.ndarray:
    """torch tensor / JAX array -> numpy (f32 for floating types)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def tree_np(tree):
    """JAX pytree -> the same structure with (writable) numpy leaves."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_np(v) for v in tree]
    return np.array(tree)


def state_dict_np(module: torch.nn.Module):
    """A port module's state dict as numpy (the tools/convert_weights input)."""
    return {k: v.detach().cpu().float().numpy()
            for k, v in module.state_dict().items()}


def close(a, b, atol: float, rtol: float = 0.0, err_msg: str = "") -> None:
    np.testing.assert_allclose(np_(a), np_(b), atol=atol, rtol=rtol,
                               err_msg=err_msg)


def splat_table(splats, b: int) -> np.ndarray:
    """Batch b's live splats (weight > 0) as one row each: means, quats,
    scales, opacity, SH, weight."""
    sp = {k: np_(v)[b] for k, v in splats.items() if k != "n_compact_dropped"}
    live = sp["weights"] > 0
    n = int(live.sum())
    return np.concatenate([sp["means"][live], sp["quats"][live], sp["scales"][live],
                           sp["opacities"][live][:, None], sp["sh"][live].reshape(n, -1),
                           sp["weights"][live][:, None]], axis=1)


def close_splat_sets(ours, ref, atol: float, rtol: float = 0.0,
                     flip_frac: float = 0.0) -> None:
    """The live splats of every batch element agree as sets of rows: the
    slot order of a voxel merge is the implementation's own, the set is
    not. Each reference row is paired with its nearest row of ours over all
    columns, and the pairing must be one to one.

    flip_frac > 0 is for splats merged from two forwards whose means differ
    by f32 rounding: a mean on a voxel edge can floor into the neighbour
    and change which splats merge (test_full_model_parity.compare_geometry
    allows the same). Then at most max(4, flip_frac * rows) rows may miss
    the band, the populations differ by no more, and every other row is
    held to it, paired one to one."""
    from scipy.spatial import cKDTree
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    for b in range(np_(ref["means"]).shape[0]):
        tab_o, tab_r = splat_table(ours, b), splat_table(ref, b)
        if flip_frac == 0.0:
            assert tab_o.shape == tab_r.shape, (b, tab_o.shape, tab_r.shape)
            _, idx = cKDTree(tab_o).query(tab_r)
            assert len(set(idx.tolist())) == len(idx), f"b={b}: rows paired twice"
            close(tab_o[idx], tab_r, atol, rtol, err_msg=f"b={b}")
            continue
        budget = max(4, int(flip_frac * len(tab_r)))
        assert abs(len(tab_o) - len(tab_r)) <= budget, (b, len(tab_o), len(tab_r))
        _, idx = cKDTree(tab_o).query(tab_r)
        ok = np.all(np.abs(tab_o[idx] - tab_r) <= atol + rtol * np.abs(tab_r), axis=1)
        assert int((~ok).sum()) <= budget, (b, int((~ok).sum()), budget)
        assert len(set(idx[ok].tolist())) == int(ok.sum()), f"b={b}: rows paired twice"


# --- multi-process workers (tests/test_torch_port_parallel*.py) --------------
# Each runs in a child that parallel.mesh.spawn starts on a gloo group over
# the CPU; the children import no JAX, so the workers live here.

def spawn_gloo(fn, n: int, *args):
    """fn(rank, device, *args) on n gloo ranks over the CPU -> the results."""
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.spawn(fn, n, backend="gloo", device="cpu", args=args)


def _f64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True)


def comm_worker(rank, device, xs, gs):
    """Every comm Function on a (1, n, 1) mesh: forward on this rank's input
    xs[name][rank], backward of sum(out * gs[name][rank])."""
    from hunyuanworld_mirror_tpu_torch.parallel import comm, mesh as mesh_lib
    n = torch.distributed.get_world_size()
    group = mesh_lib.make_mesh(1, n, 1).group("view")
    calls = {"all_gather": lambda x: comm.all_gather(x, group, 1),
             "all_to_all": lambda x: comm.all_to_all(x, group, 0, 1),
             "ppermute": lambda x: comm.ppermute(x, group, 1),
             "all_reduce": lambda x: comm.all_reduce(x, group),
             "copy_to_tp": lambda x: comm.copy_to_tp(x, group),
             "reduce_from_tp": lambda x: comm.reduce_from_tp(x, group)}
    out = {}
    for name, fn in calls.items():
        x = _f64(xs[name][rank])
        y = fn(x)
        (y * torch.tensor(gs[name][rank], dtype=torch.float64)).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def ring_worker(rank, device, cases):
    """ring_self_attention at mesh (1, n, 1) for each (q, k, v, dtype)
    case: this rank's N / n tokens -> (output, grads of sum(out^2) for f32)."""
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib, ring
    n = torch.distributed.get_world_size()
    mesh = mesh_lib.make_mesh(1, n, 1)
    out = []
    for q, k, v, dtype in cases:
        N = q.shape[1]
        sl = slice(rank * N // n, (rank + 1) * N // n)
        qkv = [torch.tensor(a[:, sl]).to(getattr(torch, dtype)).requires_grad_()
               for a in (q, k, v)]
        o = ring.ring_self_attention(*qkv, mesh, q.shape[-1] ** -0.5)
        grads = None
        if dtype == "float32":
            (o ** 2).sum().backward()
            grads = [t.grad.numpy() for t in qkv]
        out.append((o.detach().float().numpy(), grads))
    return out


def tp_block_worker(rank, device, state, x, g):
    """A Block at mesh (1, 1, n): its output on x and every parameter's
    gradient of sum(out * g), the sharded ones put back together."""
    from hunyuanworld_mirror_tpu_torch import multichip
    from hunyuanworld_mirror_tpu_torch.models.block import Block
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib, sharding
    n = torch.distributed.get_world_size()
    mesh = mesh_lib.make_mesh(1, 1, n)
    blk = Block(64, 4, init_values=0.01, qk_norm=True)
    blk.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    sharding.shard_model(blk, mesh)
    y = blk(torch.tensor(x))
    (y * torch.tensor(g)).sum().backward()
    multichip.sync_grads(blk, mesh)
    grads = {}
    for name, p in blk.named_parameters():
        kind = blk.tp_specs.get(name)
        gr = p.grad
        if kind is not None:
            from hunyuanworld_mirror_tpu_torch.parallel import comm
            gr = sharding.unshard_tensors(list(comm.gather_raw(gr[None], mesh.group("model"), 0)),
                                          kind)
        grads[name] = gr.numpy()
    return y.detach().numpy(), grads


# the toy WorldMirror of __graft_entry__.dryrun_multichip (multichip.TOY)
# with the DPT decoders narrowed as the tiny configs narrow them
TOY_NARROW = dict(dpt_features=32, dpt_out_channels=(32, 48, 64, 64))


def toy_model(state=None, seed: int = 0):
    from hunyuanworld_mirror_tpu_torch import multichip
    from hunyuanworld_mirror_tpu_torch.models import worldmirror as pwm
    model = pwm.WorldMirror(pwm.WorldMirrorConfig(**multichip.TOY, **TOY_NARROW),
                            device="cpu", seed=seed)
    if state is not None:
        model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return model


TOY_PRED_KEYS = ("depth", "pts3d", "normals", "camera_params", "camera_poses",
                 "camera_intrs", "depth_conf", "pts3d_conf", "normals_conf",
                 "gs_depth", "gs_depth_conf", "rendered_colors", "rendered_depths",
                 "rendered_alphas")


def model_worker(rank, device, state, img, dims_list, priors=None):
    """The toy forward (f32 trunk, render on) at each mesh of dims_list over
    this rank's shard of img (and of the priors, with every cond flag on)
    -> per mesh the gathered predictions."""
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib, sharding
    out = []
    views = {"img": img, **(priors or {})}
    flags = (1, 1, 1) if priors else (0, 0, 0)
    for dims in dims_list:
        mesh = mesh_lib.make_mesh(*dims)
        model = sharding.shard_model(toy_model(state), mesh)
        local = sharding.shard_views({k: torch.tensor(v) for k, v in views.items()}, mesh)
        preds = sharding.gather_predictions(
            model(local, cond_flags=flags, trunk_dtype=torch.float32, mesh=mesh), mesh)
        res = {k: np_(preds[k]) for k in TOY_PRED_KEYS}
        res["splats"] = {k: np_(v) for k, v in preds["splats"].items()}
        out.append(res)
    return out


def raster_worker(rank, device, scene, W, H, render_mode, sh_degree):
    """rasterize_distributed at mesh (1, n, 1) on this rank's splats and
    cameras -> (output, alphas, grads of sum(out^2) w.r.t. its means and
    opacities)."""
    from hunyuanworld_mirror_tpu_torch.ops.distributed import rasterize_distributed
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib, sharding
    n = torch.distributed.get_world_size()
    mesh = mesh_lib.make_mesh(1, n, 1)
    means, quats, scales, opac, colors, viewmats, Ks = (
        sharding.axis_part(torch.tensor(a), mesh, "view", 0) for a in scene)
    means.requires_grad_()
    opac.requires_grad_()
    out, alpha = rasterize_distributed(means, quats, scales, opac, colors, viewmats,
                                       Ks, W, H, mesh, render_mode=render_mode,
                                       impl="jax", sh_degree=sh_degree)
    (out ** 2).sum().backward()
    return np_(out), np_(alpha), np_(means.grad), np_(opac.grad)


def ba_worker(rank, device, w2c, K, tracks, iters):
    """bundle_adjust with the landmarks sharded over mesh (1, n, 1)."""
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib
    from hunyuanworld_mirror_tpu_torch.refine import ba
    n = torch.distributed.get_world_size()
    mesh = mesh_lib.make_mesh(1, n, 1)
    tr = ba.Tracks(*(torch.tensor(a) for a in tracks))
    poses, pts, cost0, cost = ba.bundle_adjust(torch.tensor(w2c), torch.tensor(K), tr,
                                               iters=iters, mesh=mesh)
    return np_(poses), np_(pts), float(cost0), float(cost)


def checkpoint_worker(rank, device, dims, path, state_a, state_b):
    """save_sharded of the toy model (state_a) after one AdamW step (on
    stand-in gradients) at mesh dims, then load_sharded into a model made from state_b on the same mesh
    -> (the gathered state after the step, after the load; the optimizer's
    counts after the load; whether the moments came back)."""
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib, sharding
    from hunyuanworld_mirror_tpu_torch.training import checkpoint
    from hunyuanworld_mirror_tpu_torch.training.trainer import AdamWCosine
    mesh = mesh_lib.make_mesh(*dims)
    model = sharding.shard_model(toy_model(state_a), mesh)
    opt = AdamWCosine(model, 1e-4, None, 1e-4)
    for p in model.parameters():       # a step on stand-in gradients
        p.grad = torch.cos(p.detach() * 7.0)
    opt.step()
    saved = sharding.gather_state(model, mesh)
    checkpoint.save_sharded(path, model, mesh, step=7, optimizer=opt)
    other = sharding.shard_model(toy_model(state_b), mesh)
    opt2 = AdamWCosine(other, 1e-4, None, 1e-4)
    step = checkpoint.load_sharded(path, other, mesh, optimizer=opt2)
    loaded = sharding.gather_state(other, mesh)
    _, _, mu_a, nu_a = opt.export_state()
    counts, sched, mu_b, nu_b = opt2.export_state()
    same = all(torch.equal(mu_a[k], mu_b[k]) and torch.equal(nu_a[k], nu_b[k])
               for k in mu_a)
    return ({k: np_(v) for k, v in saved.items()}, {k: np_(v) for k, v in loaded.items()},
            (step, counts, sched), same)


def jobs_worker(rank, device, jobs):
    """Several workers in one process group, one after the other: jobs is a
    list of (worker, args) -> the list of their results."""
    return [fn(rank, device, *args) for fn, args in jobs]
