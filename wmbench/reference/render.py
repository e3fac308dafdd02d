"""Plain PyTorch Gaussian render: head features -> splats -> images.

Written from 3D Gaussian Splatting (Kerbl et al. 2023, gsplat's
semantics) and WorldMirror's Gaussian head, checked line by line against
hunyuanworld_mirror_tpu_torch/models/gaussians.py, ops/projection.py,
ops/tiles.py and ops/rasterizer_ref.py at commit
e2e15df8eb5b1f9149d8000ecb6c575b37fbec06, whose stated semantics it keeps:

- the splats: the 2-conv head, quats normalised, scales exp clamped at
  0.3, opacities and weights sigmoid, SH residual over RGB2SH(image), means
  unprojected from gs_depth through the given cameras; the voxel merge
  (weights-averaged, opacity = sum w^2 / sum w); the compaction to the
  ceil_512(N / 2) heaviest;
- the render of each camera: the pinhole EWA projection (FOV clamp, eps2d
  0.3, 3.33-sigma radii, near 0.01), opacity-tight radii, each splat's
  first `max_tiles_per_gauss` tiles of its clamped box, row-major, kept
  where its alpha >= 1/255 ellipse reaches the tile's pixel centres, at
  most `max_per_tile` entries a tile, nearest first; the blend: pixel
  centres at +0.5, alpha = min(0.999, op e^-sigma), skipped below 1/255,
  front to back until the transmittance would fall to 1e-4; RGB and the
  expected depth (accumulated depth over alpha).

Entries are ordered by their exact depth (the program sorts a quantized
depth), and blended a block of tiles at a time. No module of the program
is imported.
"""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .precision import REFERENCE, Precision
from .weights import gs_splits

C0 = 0.28209479177387814
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


# --- cameras -------------------------------------------------------------------

def quat_to_rotmat(q):
    """(..., 4) XYZW -> (..., 3, 3)."""
    i, j, k, r = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    return torch.stack([1 - s * (j * j + k * k), s * (i * j - k * r), s * (i * k + j * r),
                        s * (i * j + k * r), 1 - s * (i * i + k * k), s * (j * k - i * r),
                        s * (i * k - j * r), s * (j * k + i * r), 1 - s * (i * i + j * j)],
                       -1).reshape(q.shape[:-1] + (3, 3))


def camera_matrices(cam: torch.Tensor, H: int, W: int):
    """(V, 9) [t, quat xyzw, fov_v, fov_u] -> world->camera (V, 4, 4), K
    (V, 3, 3), principal point at the centre."""
    R = quat_to_rotmat(cam[:, 3:7])
    w2c = torch.zeros(cam.shape[0], 4, 4, dtype=cam.dtype, device=cam.device)
    w2c[:, :3, :3] = R
    w2c[:, :3, 3] = cam[:, :3]
    w2c[:, 3, 3] = 1.0
    fy = H * 0.5 / torch.clamp_min(torch.tan(cam[:, 7] * 0.5), 1e-6)
    fx = W * 0.5 / torch.clamp_min(torch.tan(cam[:, 8] * 0.5), 1e-6)
    K = torch.zeros(cam.shape[0], 3, 3, dtype=cam.dtype, device=cam.device)
    K[:, 0, 0], K[:, 1, 1] = fx, fy
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W * 0.5, H * 0.5, 1.0
    return w2c, K


# --- splats --------------------------------------------------------------------

def make_splats(sd, cfg, gs_feat, gs_depth, images, cams, prec: Precision = REFERENCE):
    """gs_feat (B, S, H, W, f/2), gs_depth (B, S, H, W, 1), images, cams
    (B, S, 9) -> activated splats of batch 0, each (N = S*H*W, ...), quats
    wxyz."""
    rnd = prec.heads
    B, S, H, W, _ = images.shape
    x = gs_feat.reshape(B * S, H, W, -1).permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(rnd(x), rnd(sd["gs_renderer.gs_head.0.weight"]), padding=1))
    x = F.conv2d(rnd(x), rnd(sd["gs_renderer.gs_head.2.weight"]),
                 sd["gs_renderer.gs_head.2.bias"])
    raw = x.permute(0, 2, 3, 1).reshape(B, S * H * W, -1)[0]
    quats, scales, opac, sh, weights = torch.split(raw, gs_splits(cfg), -1)
    res = sh.reshape(sh.shape[0], -1, 3)
    dc = (images[0].reshape(-1, 3) - 0.5) / C0
    w2c, K = camera_matrices(cams[0], H, W)
    c2w_R = w2c[:, :3, :3].transpose(1, 2)
    c2w_t = -torch.einsum("sij,sj->si", c2w_R, w2c[:, :3, 3])
    u = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
    v = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None]
    z = gs_depth[0, ..., 0]
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    cam_pts = torch.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], -1)
    means = torch.einsum("shwi,sji->shwj", cam_pts, c2w_R) + c2w_t[:, None, None]
    return {
        "means": means.reshape(-1, 3),
        "quats": quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-8),
        "scales": torch.clamp_max(torch.exp(scales), 0.3),
        "opacities": torch.sigmoid(opac[:, 0]),
        "weights": torch.sigmoid(weights[:, 0]),
        "sh": torch.cat([res[:, :1] + dc[:, None], res[:, 1:]], 1),
    }


def voxel_merge(s: Dict[str, torch.Tensor], voxel: float) -> Dict[str, torch.Tensor]:
    """Merge the splats that share a voxel: means, scales, quats (then
    normalised) and SH weight-averaged, opacity sum w^2 / sum w, weight
    sum w -> the merged splats only (U, ...)."""
    vox = torch.floor(s["means"] / voxel)
    vox = torch.clamp(vox - vox.min(0, keepdim=True).values, 0, (1 << 20) - 1).long()
    key = (vox[:, 0] << 40) | (vox[:, 1] << 20) | vox[:, 2]
    _, inv = torch.unique(key, return_inverse=True)
    U = int(inv.max()) + 1
    w = s["weights"]
    N = w.shape[0]
    planes = torch.cat([w[:, None], (w * w)[:, None], w[:, None] * s["means"],
                        w[:, None] * s["scales"], w[:, None] * s["quats"],
                        w[:, None] * s["sh"].reshape(N, -1)], 1)
    acc = torch.zeros(U, planes.shape[1], device=w.device).index_add_(0, inv, planes)
    wsum = torch.clamp_min(acc[:, 0], 1e-8)
    alive = acc[:, 0] > 1e-6
    q = acc[:, 8:12]
    q = q / torch.sqrt(torch.clamp_min((q * q).sum(-1), 1e-16))[:, None]
    return {"means": acc[:, 2:5] / wsum[:, None], "scales": acc[:, 5:8] / wsum[:, None],
            "quats": q, "sh": (acc[:, 12:] / wsum[:, None]).reshape(U, *s["sh"].shape[1:]),
            "opacities": torch.where(alive, acc[:, 1] / wsum, 0.0),
            "weights": torch.where(alive, wsum, 0.0)}


def compact(s: Dict[str, torch.Tensor], n_slots: int) -> Dict[str, torch.Tensor]:
    """The ceil_512(n_slots / 2) heaviest live splats."""
    cap = -(-(n_slots // 2) // 512) * 512
    live = s["weights"] > 0
    s = {k: v[live] for k, v in s.items()}
    if s["weights"].shape[0] > cap:
        order = torch.sort(s["weights"], descending=True, stable=True).indices[:cap]
        s = {k: v[order] for k, v in s.items()}
    return s


def splats(sd, cfg, gs_feat, gs_depth, images, cams, prec: Precision = REFERENCE):
    s = make_splats(sd, cfg, gs_feat, gs_depth, images, cams, prec)
    return compact(voxel_merge(s, cfg["voxel_size"]), s["means"].shape[0])


# --- projection ------------------------------------------------------------------

def project(s, w2c, K, W, H, eps2d=0.3, near=0.01, far=1e10):
    """One pinhole camera: (means2d (N, 2), conics (N, 3), depths (N,),
    radii (N, 2) float, 0 where culled)."""
    q = s["quats"][:, [1, 2, 3, 0]]
    R = quat_to_rotmat(q / torch.linalg.norm(q, dim=-1, keepdim=True))
    M = R * s["scales"][:, None, :]
    cov = M @ M.transpose(1, 2)
    Rc, t = w2c[:3, :3], w2c[:3, 3]
    mc = s["means"] @ Rc.T + t
    covc = Rc @ cov @ Rc.T
    tx, ty, tz = mc.unbind(-1)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    tanx, tany = 0.5 * W / fx, 0.5 * H / fy
    lxn, lxp = cx / fx + 0.3 * tanx, (W - cx) / fx + 0.3 * tanx
    lyn, lyp = cy / fy + 0.3 * tany, (H - cy) / fy + 0.3 * tany
    txc = tz * torch.clamp(tx / tz, -lxn, lxp)
    tyc = tz * torch.clamp(ty / tz, -lyn, lyp)
    J = torch.zeros(tz.shape[0], 2, 3, device=tz.device)
    J[:, 0, 0], J[:, 0, 2] = fx / tz, -fx * txc / (tz * tz)
    J[:, 1, 1], J[:, 1, 2] = fy / tz, -fy * tyc / (tz * tz)
    c2 = J @ covc @ J.transpose(1, 2)
    a, b, d = c2[:, 0, 0] + eps2d, c2[:, 0, 1], c2[:, 1, 1] + eps2d
    det = torch.clamp_min(a * d - b * b, 1e-10)
    conics = torch.stack([d / det, -b / det, a / det], -1)
    u = fx * tx / tz + cx
    v = fy * ty / tz + cy
    rx, ry = torch.ceil(3.33 * torch.sqrt(a)), torch.ceil(3.33 * torch.sqrt(d))
    ok = ((det > 0) & (tz > near) & (tz < far) & (u + rx > 0) & (u - rx < W)
          & (v + ry > 0) & (v - ry < H))
    radii = torch.where(ok[:, None], torch.stack([rx, ry], -1), 0.0)
    return torch.stack([u, v], -1), conics, tz, radii


def tight_radii(radii, op):
    """Radii shrunk to the alpha >= 1/255 level set; 0 where op <= 1/255."""
    lvl = 2.0 * torch.log(torch.clamp_min(op, 1e-12) * 255.0)
    f = torch.clamp_max(torch.sqrt(torch.clamp_min(lvl, 0.0)) / 3.33, 1.0)
    return torch.where((lvl > 0)[:, None], torch.ceil(radii * f[:, None]), 0.0)


def _rect_sigma_min(u, v, ca, cb, cc, x0, x1, y0, y1):
    """Least of the conic's quadratic over the rectangle [x0, x1] x [y0, y1]."""
    inside = (u >= x0) & (u <= x1) & (v >= y0) & (v <= y1)

    def edge_x(xe):
        dx = xe - u
        t = torch.minimum(torch.maximum(-cb * dx / torch.clamp_min(cc, 1e-12), y0 - v), y1 - v)
        return 0.5 * (ca * dx * dx + cc * t * t) + cb * dx * t

    def edge_y(ye):
        dy = ye - v
        t = torch.minimum(torch.maximum(-cb * dy / torch.clamp_min(ca, 1e-12), x0 - u), x1 - u)
        return 0.5 * (ca * t * t + cc * dy * dy) + cb * t * dy

    m = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                      torch.minimum(edge_y(y0), edge_y(y1)))
    return torch.where(inside, torch.zeros_like(m), m)


def entries(m2d, conics, op, radii, W, H, ts, tpg):
    """(tile ids, splat ids) of every (splat, tile) entry: each splat's
    first `tpg` tiles of its clamped tile box, row-major, where its alpha
    >= 1/255 ellipse reaches the tile's pixel centres (1e-3 of margin)."""
    tw, th = -(-W // ts), -(-H // ts)
    u, v = m2d[:, 0], m2d[:, 1]
    rx, ry = radii[:, 0], radii[:, 1]
    x0 = torch.clamp(torch.floor((u - rx) / ts), 0, tw)
    x1 = torch.clamp(torch.ceil((u + rx) / ts), 0, tw)
    y0 = torch.clamp(torch.floor((v - ry) / ts), 0, th)
    y1 = torch.clamp(torch.ceil((v + ry) / ts), 0, th)
    bw = torch.clamp_min(x1 - x0, 1)
    cover = torch.where((rx > 0) & (ry > 0), (x1 - x0) * (y1 - y0), 0.0)
    lvl = torch.log(torch.clamp_min(op, 1e-12) * 255.0) + 1e-3
    tiles, ids = [], []
    idx = torch.arange(u.shape[0], device=u.device)
    for k in range(tpg):
        kk = torch.full_like(bw, float(k))
        tx = x0 + torch.fmod(kk, bw)
        ty = y0 + torch.floor(kk / bw)
        px0, py0 = tx * ts + 0.5, ty * ts + 0.5
        smin = _rect_sigma_min(u, v, conics[:, 0], conics[:, 1], conics[:, 2],
                               px0, px0 + ts - 1, py0, py0 + ts - 1)
        ok = (k < cover) & (smin <= lvl)
        tiles.append((ty * tw + tx)[ok].long())
        ids.append(idx[ok])
    return torch.cat(tiles), torch.cat(ids)


def render_camera(s, w2c, K, W, H, rcfg, rnd=lambda x: x,
                  budget: int = 1 << 26) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One camera: (RGB + expected depth (H, W, 4), alpha (H, W, 1), the
    entries blended)."""
    ts, cap = rcfg["tile_size"], rcfg["max_per_tile"]
    m2d, conics, depth, radii = project(s, w2c, K, W, H)
    op = s["opacities"]
    radii = tight_radii(radii, op)
    if s["sh"].shape[1] != 1:
        raise ValueError("the reference renders SH degree 0 only")
    rgb = torch.clamp_min(C0 * s["sh"][:, 0, :] + 0.5, 0.0)
    cols = torch.cat([rgb, depth[:, None]], -1)
    tile, sid = entries(m2d, conics, op, radii, W, H, ts, rcfg["max_tiles_per_gauss"])
    tw, th = -(-W // ts), -(-H // ts)
    n_tiles = tw * th
    # order by (tile, depth, splat id): stable sorts, last key first
    o = torch.argsort(sid, stable=True)
    o = o[torch.argsort(depth[sid[o]], stable=True)]
    o = o[torch.argsort(tile[o], stable=True)]
    tile, sid = tile[o], sid[o]
    counts = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tile.shape[0], device=tile.device) - starts[tile]
    keep = rank < cap
    tile, sid, rank = tile[keep], sid[keep], rank[keep]
    counts = torch.clamp_max(counts, cap)
    n_isects = int(counts.sum())

    P = ts * ts
    py, px = torch.meshgrid(torch.arange(ts, device=tile.device),
                            torch.arange(ts, device=tile.device), indexing="ij")
    params = torch.cat([m2d, conics, op[:, None], cols], -1)
    params = torch.cat([params[:, :2], rnd(params[:, 2:])], -1)
    img = torch.zeros(n_tiles, P, cols.shape[1], device=tile.device)
    alpha_img = torch.zeros(n_tiles, P, device=tile.device)
    order = torch.argsort(counts, descending=True)
    cnt = counts[order].tolist()
    i = 0
    while i < n_tiles and cnt[i] > 0:
        K_ = cnt[i]
        nb = max(1, min(n_tiles - i, budget // (K_ * P)))
        blk = order[i:i + nb]
        table = torch.full((n_tiles,), -1, dtype=torch.long, device=tile.device)
        table[blk] = torch.arange(blk.shape[0], device=tile.device)
        sel = (table[tile] >= 0) & (rank < K_)
        slots = torch.full((blk.shape[0], K_), -1, dtype=torch.long, device=tile.device)
        slots[table[tile[sel]], rank[sel]] = sid[sel]
        valid = slots >= 0
        g = params[slots.clamp_min(0)]                       # (nb, K, 6 + D)
        tx = (blk % tw).float()[:, None] * ts + px.reshape(-1).float()[None] + 0.5
        ty = (blk // tw).float()[:, None] * ts + py.reshape(-1).float()[None] + 0.5
        dx = tx[:, None, :] - g[..., 0:1]
        dy = ty[:, None, :] - g[..., 1:2]
        sigma = 0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy) + g[..., 3:4] * dx * dy
        a = torch.clamp_max(g[..., 5:6] * torch.exp(-sigma), 0.999)
        a = torch.where((sigma >= 0) & (a >= ALPHA_MIN) & valid[..., None], a, 0.0)
        t_after = torch.cumprod(1.0 - a, 1)
        t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], 1)
        w = a * t_before * (t_after > T_EPS)
        img[blk] = torch.einsum("bkp,bkd->bpd", w, g[..., 6:])
        alpha_img[blk] = w.sum(1)
        i += nb
    img = img.reshape(th, tw, ts, ts, -1).permute(0, 2, 1, 3, 4).reshape(th * ts, tw * ts, -1)
    alpha_img = alpha_img.reshape(th, tw, ts, ts).permute(0, 2, 1, 3).reshape(th * ts, tw * ts)
    img, alpha_img = img[:H, :W], alpha_img[:H, :W, None]
    img = torch.cat([img[..., :3], img[..., 3:] / torch.clamp_min(alpha_img, 1e-10)], -1)
    return img, alpha_img, n_isects


def render(s, cams, H, W, rcfg, prec: Precision = REFERENCE):
    """Every camera of (V, 9) vectors -> colours (V, H, W, 3), expected
    depths (V, H, W, 1), alphas (V, H, W, 1), entries blended (V,)."""
    w2c, K = camera_matrices(cams, H, W)
    outs = [render_camera(s, w2c[c], K[c], W, H, rcfg, prec.render)
            for c in range(cams.shape[0])]
    img = torch.stack([o[0] for o in outs])
    return (img[..., :3], img[..., 3:], torch.stack([o[1] for o in outs]),
            [o[2] for o in outs])


def count_isects(s, cams, H, W, rcfg):
    """(entries blended, splats with an entry) of each camera of `cams`
    (V, 9), by this file's rule, without blending: the work counts the
    blend's rooflines divide by."""
    w2c, K = camera_matrices(cams, H, W)
    out = []
    for c in range(cams.shape[0]):
        m2d, conics, _, radii = project(s, w2c[c], K[c], W, H)
        radii = tight_radii(radii, s["opacities"])
        tile, sid = entries(m2d, conics, s["opacities"], radii, W, H, rcfg["tile_size"],
                            rcfg["max_tiles_per_gauss"])
        n_tiles = -(-W // rcfg["tile_size"]) * -(-H // rcfg["tile_size"])
        counts = torch.bincount(tile, minlength=n_tiles)
        out.append((int(torch.clamp_max(counts, rcfg["max_per_tile"]).sum()),
                    int(torch.unique(sid).numel())))
    return out
