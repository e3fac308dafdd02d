"""The port's render, binning and conv measuring tools on the CPU.

Each tool's pieces composed against the port's own composed function, bit
for bit: render_profile's stages A -> B -> C and D1 -> D2 -> D3 against
gaussians.render's rendered_colors, bin_ab's pieces against
tiles.bin_gaussians_packed, every sort_ab2 permutation against
tiles._sort_slots. Against the JAX package, exactly: bin_ab's keys stage
against tiles._isect_keys, isect_stats' counts and exact-cover histogram
against tiles.opacity_tight_radii and tools/isect_stats.py's numpy
rect_sigma_min. conv_ab's hook list against the heads' modules,
render_sweep's knobs through a stand-in runner, and each tool's main
without a card and on the CPU at the tiny preset.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (the intra-op thread cap)
from hunyuanworld_mirror_tpu.ops import tiles as jtiles
from hunyuanworld_mirror_tpu_torch import (bin_ab, conv_ab, isect_stats, render_profile,
                                           render_sweep, sort_ab2)
from hunyuanworld_mirror_tpu_torch.models import gaussians
from hunyuanworld_mirror_tpu_torch.ops import tiles
from hunyuanworld_mirror_tpu_torch.utils.scenes import render_scene
from tools import isect_stats as jax_isect_stats

TINY = ["--device", "cpu", "--preset", "tiny", "--img", "56", "--views", "2"]


@pytest.fixture(scope="module")
def scene():
    return render_scene("tiny", S=2, img=56, seed=0, device="cpu")


# --- (a) render_profile ------------------------------------------------------

@pytest.mark.parametrize("fields", [{}, {"slot_fracs": "auto", "payload_f16": False}])
def test_render_profile_stages_compose_to_the_render(scene, fields):
    from dataclasses import replace
    renderer = scene.model.gs_renderer
    base = renderer.cfg
    renderer.cfg = replace(base, **fields)
    try:
        cfg = renderer.cfg
        B, S, H, W, _ = scene.images.shape
        with torch.no_grad():
            head_prepare, prune, compact = render_profile.splat_stages(scene)
            comp = compact(prune(head_prepare(scene.gs_feat)))
            w2c, Ks = gaussians.camera_matrices(scene.preds["camera_params"], B, S, H, W)
            splats = {k: comp[k][0] for k in gaussians.SPLAT_KEYS}
            project, bin_all, blend = render_profile.camera_stages(
                cfg, splats, w2c[0], Ks[0], W, H, "cpu")
            colors, _ = blend(bin_all(project()))
            ref = gaussians.render(renderer, scene.gs_feat, scene.images,
                                   dict(scene.preds))["rendered_colors"][0]
    finally:
        renderer.cfg = base
    assert torch.equal(colors[..., :3], ref)


# --- (b) bin_ab ----------------------------------------------------------------

@pytest.mark.parametrize("tpg", [4, 9])
def test_bin_ab_pieces_compose_to_bin_gaussians_packed(tpg):
    cam = bin_ab.synthetic_camera(3000, np.random.default_rng(tpg), "cpu")
    steps, composed = bin_ab.pieces(tpg, mpt=4)
    ref = steps["full_bin"](*cam)
    assert bin_ab.bins_equal(composed(*cam), ref)
    assert int(ref.n_dropped) > 0      # the cap of 4 a tile cuts


@pytest.mark.parametrize("tpg", [4, 9])
def test_bin_ab_keys_equal_jax(tpg):
    m2d, rad, dep = bin_ab.synthetic_camera(3000, np.random.default_rng(7 + tpg), "cpu")[:3]
    steps, _ = bin_ab.pieces(tpg)
    ours = steps["keys"](m2d, rad, dep)
    tw = th = -(-bin_ab.W // bin_ab.TILE)
    key, n_cover, valid = jtiles._isect_keys(
        jnp.asarray(m2d.numpy()), jnp.asarray(rad.numpy()), jnp.asarray(dep.numpy()),
        bin_ab.TILE, tw, th, tpg, depth_bits=tiles.depth_bits_for(tw * th))
    np.testing.assert_array_equal(ours["key"].numpy(), np.asarray(key))
    np.testing.assert_array_equal(ours["n_cover"].numpy(), np.asarray(n_cover))
    np.testing.assert_array_equal(ours["valid"].numpy(), np.asarray(valid))


# --- (c) sort_ab2 --------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(sort_ab2.VARIANTS))
@pytest.mark.parametrize("rows", [4096, 9 * 1000 + 7])
def test_sort_ab2_permutations_equal_the_shipped_sort(variant, rows):
    key = sort_ab2.draw_keys(rows, np.random.default_rng(rows), "cpu")
    assert len(torch.unique(key)) < rows // 2          # ties on most keys
    perm = sort_ab2.VARIANTS[variant](key)
    assert torch.equal(perm, tiles._sort_slots(key)[1])


# --- (d) isect_stats -------------------------------------------------------------

def projected_inputs(seed, n=2000, W=64, H=48):
    """Seeded projected splats: centres over and around the image, SPD
    conics, radii 0-40 px (some 0: invalid), opacities some under 1/255."""
    rng = np.random.default_rng(seed)
    m2d = (rng.uniform(-0.2, 1.2, size=(n, 2)) * [W, H]).astype(np.float32)
    sx, sy = rng.uniform(0.5, 12.0, size=(2, n))
    rho = rng.uniform(-0.9, 0.9, size=n)
    cov = np.stack([sx * sx, rho * sx * sy, sy * sy], -1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    con = np.stack([cov[:, 2], -cov[:, 1], cov[:, 0]], -1) / det[:, None]
    rad = np.ceil(3.33 * np.sqrt(np.stack([cov[:, 0], cov[:, 2]], -1)))
    rad[rng.uniform(size=n) < 0.05] = 0
    op = rng.uniform(0.0, 1.0, size=n) ** 2
    return (m2d, con.astype(np.float32), rad.astype(np.int32), op.astype(np.float32))


def jax_counts(m2d, con, rad, op, ts, tw, th):
    """tools/isect_stats.py's counts for one camera, its loop as written
    there, with the JAX package's opacity_tight_radii."""
    tight = np.asarray(jtiles.opacity_tight_radii(jnp.asarray(rad), jnp.asarray(op)))

    def cover_counts(u, v, rx, ry):
        txmin = np.clip(np.floor((u - rx) / ts), 0, tw).astype(np.int64)
        txmax = np.clip(np.ceil((u + rx) / ts), 0, tw).astype(np.int64)
        tymin = np.clip(np.floor((v - ry) / ts), 0, th).astype(np.int64)
        tymax = np.clip(np.ceil((v + ry) / ts), 0, th).astype(np.int64)
        valid = (rx > 0) & (ry > 0)
        return (np.where(valid, (txmax - txmin) * (tymax - tymin), 0),
                txmin, tymin, txmax - txmin, tymax - tymin, valid)

    u, v = m2d[:, 0], m2d[:, 1]
    a, b, cc = con[:, 0], con[:, 1], con[:, 2]
    n_aabb = cover_counts(u, v, rad[:, 0], rad[:, 1])[0].sum()
    cov_t, txm, tym, bw, bh, valid = cover_counts(u, v, tight[:, 0], tight[:, 1])
    lvl = np.log(np.maximum(op, 1e-12) * 255.0)
    n_ell = np.zeros(len(u), np.int64)
    for j in range(min(int((bw * bh).max()), 32)):
        has = (j < bw * bh) & valid
        jx = txm + j % np.maximum(bw, 1)
        jy = tym + j // np.maximum(bw, 1)
        x0, x1 = jx * ts + 0.5, (jx + 1) * ts - 0.5
        y0, y1 = jy * ts + 0.5, (jy + 1) * ts - 0.5
        smin = jax_isect_stats.rect_sigma_min(u, v, a, b, cc, x0, x1, y0, y1)
        n_ell += (has & (smin <= lvl)).astype(np.int64)
    return n_aabb, cov_t.sum(), n_ell


@pytest.mark.parametrize("seed,ts", [(0, 16), (1, 8)])
def test_isect_stats_counts_equal_jax(seed, ts):
    m2d, con, rad, op = projected_inputs(seed)
    tw, th = -(-64 // ts), -(-48 // ts)
    ours = isect_stats.intersection_counts(*(torch.as_tensor(a) for a in (m2d, con, rad, op)),
                                           ts, tw, th)
    n_aabb, n_tight, n_ell = jax_counts(m2d, con, rad, op, ts, tw, th)
    assert (int(ours["aabb"]), int(ours["tight"])) == (n_aabb, n_tight)
    np.testing.assert_array_equal(ours["per_splat"].numpy(), n_ell)
    assert int(ours["ellipse"]) == n_ell.sum() < n_tight < n_aabb
    hist, tail = isect_stats.cover_histogram(ours["per_splat"])
    ref = np.bincount(np.minimum(n_ell, 11), minlength=12)
    np.testing.assert_array_equal(hist.numpy(), ref)
    frac = ref / ref.sum()
    np.testing.assert_allclose(tail.numpy(), np.cumsum(frac[::-1])[::-1], rtol=1e-12)


# --- (e) conv_ab -----------------------------------------------------------------

def test_conv_ab_hooks_list_every_head_conv(scene):
    entries = conv_ab.collect_convs(scene.model, scene.token_list, scene.images,
                                    scene.patch_start_idx)
    modules = {f"{h}.{n}": m for h in conv_ab.HEADS
               for n, m in getattr(scene.model, h).named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))}
    names = [n for e in entries for n in e.names]
    assert sorted(names) == sorted(modules)           # each called once a forward
    assert sum(e.calls for e in entries) == len(modules)
    assert len(entries) < len(modules)                # shapes shared across heads
    for e in entries:
        assert e.calls == len(e.names)
        m = modules[e.names[0]]
        B, cin, h, w = e.in_shape
        if isinstance(m, torch.nn.ConvTranspose2d):
            assert e.kind == "deconv" and e.out_shape[2:] == (h * m.stride[0], w * m.stride[1])
        else:
            h = (h + 2 * m.padding[0] - m.kernel_size[0]) // m.stride[0] + 1
            w = (w + 2 * m.padding[1] - m.kernel_size[1]) // m.stride[1] + 1
            assert e.kind == "conv" and e.out_shape[2:] == (h, w)
        assert e.flops == (2.0 * B * h * w * m.kernel_size[0] * m.kernel_size[1]
                           * m.in_channels * m.out_channels / m.groups)


# --- (f) render_sweep --------------------------------------------------------------

@pytest.mark.parametrize("knob", render_sweep.TPU_ONLY)
def test_render_sweep_refuses_tpu_knobs(knob, capsys):
    with pytest.raises(SystemExit):
        render_sweep.parse(["--knob", "group", knob])
    assert "Pallas" in capsys.readouterr().err


WANT = {"group": ("WM_RASTER_GROUP", ["1", "4", "8", "16"]),
        "tile": ("tile_size", [16, 8]), "binning": ("slot_fracs", [None, "auto"]),
        "exact_tile": ("exact_tile_test", [True, False]),
        "payload": ("payload_f16", [True, False]),
        "impl": ("rasterizer_impl", ["pallas", "jax"])}


@pytest.mark.parametrize("knob", sorted(WANT))
def test_render_sweep_maps_each_knob(knob, monkeypatch):
    monkeypatch.delenv("WM_RASTER_GROUP", raising=False)
    name, want = WANT[knob]
    seen = []

    def runner(cfg, label):
        seen.append(os.environ.get(name) if name.startswith("WM_") else getattr(cfg, name))
        return {"colors": torch.full((2,), float(len(seen)))}

    rows = render_sweep.sweep(knob, gaussians.GSRendererConfig(), runner)
    assert seen == want and [r["max_delta"] for r in rows[1:]] == list(
        range(1, len(want)))
    assert "WM_RASTER_GROUP" not in os.environ


def test_render_sweep_restores_the_environment_after_a_failure(monkeypatch):
    monkeypatch.setenv("WM_RASTER_GROUP", "2")

    def runner(cfg, label):
        if label.endswith("=8"):
            raise RuntimeError("a failing setting")
        return {"colors": torch.zeros(1)}

    with pytest.raises(RuntimeError, match="failing"):
        render_sweep.sweep("group", gaussians.GSRendererConfig(), runner)
    assert os.environ["WM_RASTER_GROUP"] == "2"


# --- (g) each main: no card, then the CPU rehearsal ---------------------------------

MAINS = {"render_profile": render_profile, "render_sweep": render_sweep,
         "bin_ab": bin_ab, "sort_ab2": sort_ab2, "isect_stats": isect_stats,
         "conv_ab": conv_ab}


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_tool_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MAINS[tool].main(["--iters", "1"] if tool != "isect_stats" else [])


def test_render_profile_rehearses_on_the_cpu(capsys):
    out = render_profile.main(TINY + ["--iters", "1"])
    assert out["stages_equal"] and set(out["ms"].values()) == {None}
    assert min(out["n_isects"]) > 0 and out["dm_delta"]["median"] < 1e-3
    lines = capsys.readouterr().out.strip().splitlines()
    assert all(line.endswith("[cpu]") for line in lines[:-1])
    assert '"tool": "render_profile"' in lines[-1]


@pytest.mark.parametrize("tool,argv", [
    ("render_sweep", ["--knob", "group", "payload"]),
    ("isect_stats", []),
    ("conv_ab", ["--iters", "1"]),
])
def test_scene_tools_rehearse_on_the_cpu(scene, tool, argv, capsys):
    out = MAINS[tool].main(["--device", "cpu"] + argv, scene=scene)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert f'"tool": "{tool}"' in last and '"card": "cpu"' in last
    if tool == "render_sweep":
        assert [r["ms"] for r in out["knobs"]["group"]] == [None] * 4
        assert out["knobs"]["group"][3]["max_delta"] == 0.0   # K5's windows cut nothing
    elif tool == "isect_stats":
        for cnt, n in zip(out["per_camera"], out["render_n_isects"]):
            assert cnt["ellipse"] <= cnt["tight"] <= cnt["aabb"] and n == cnt["binned"]
    else:
        assert out["sums_ms"]["f32"] is None and out["heads_f32_ms"] is None
        assert out["calls"] == sum(r["calls"] for r in out["convs"])


@pytest.mark.parametrize("tool,argv", [
    ("bin_ab", ["--n", "2048", "--cams", "2"]),
    ("sort_ab2", ["--n", "1024"]),
])
def test_synthetic_tools_rehearse_on_the_cpu(tool, argv):
    out = MAINS[tool].main(["--device", "cpu", "--iters", "1"] + argv)
    if tool == "bin_ab":
        assert out["composed_equal"] and out["rows_per_camera"] == 2048 * 4
        assert set(out["ms_per_camera"].values()) == {None}
    else:
        assert all(v["equal"] for r in out["ab"].values() for v in r.values())
        assert set(out["rows"]) == {int(1024 * s) for s in sort_ab2.ROW_SLOTS}
