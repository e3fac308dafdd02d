"""The flat binning's two routes on the CPU: the plain code's list
(tiles.bin_gaussians_packed_plain, N*TPG rows) and kernel K7's list of the
live rows alone (tiles.bin_gaussians_packed on the card).

The plain list cut to its live rows blends as the whole list does, in the
plain K2 and the plain K3, bit for bit: the blend reads only the tiles'
segments, and so do K5's group windows (WM_RASTER_GROUP > 1). On the CPU
bin_gaussians_packed takes the plain code and counts the route. K7's
wrapper hands its C entries their arguments (a stand-in launch that
emulates them through their pointers), and its list is the plain list's
live prefix. The benchmark's readers of the route's counters read them."""

import ctypes
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_port_train_raster import TILE, W, H, _projected
from torch_port_helpers import t
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat
from hunyuanworld_mirror_tpu_torch.ops import tiles as ptiles
from hunyuanworld_mirror_tpu_torch.utils import profiling as pprof

TW, TH = -(-W // TILE), -(-H // TILE)

# (payload_f16, with_ids, max_tiles_per_gauss, max_per_tile, exact test)
CASES = {"f32_ids_tpg9": (False, True, 9, 1024, True),
         "f16_tpg4": (True, False, 4, 1024, True),
         "f32_ids_capped": (False, True, 9, 4, True),
         "f16_capped_no_test": (True, False, 4, 4, False)}


def _scene(n=400):
    s = _projected(n)
    return (t(s["m2d"]), t(s["con"]), t(s["col"]), t(s["op"]), torch.tensor(s["rad"]),
            t(s["dep"]))


def _args(scene, f16, with_ids, tpg, mpt, exact):
    m2d, con, col, op, rad, dep = scene
    vals = prast.payload_planes(m2d, con, col, op, f16)
    ct = ptiles.conic_test_planes(con, op) if exact else None
    return (m2d, rad, dep, vals, TILE, TW, TH, tpg, mpt, ct, with_ids)


def _n_live(args):
    m2d, rad, dep, _, ts, tw, th, tpg, _, ct, _ = args
    db = ptiles.depth_bits_for(tw * th)
    key, _, _ = ptiles._isect_keys(m2d, rad, dep, ts, tw, th, tpg, db, ct)
    return int(((key >> db) < tw * th).sum())


def _cut(bins, n):
    return bins._replace(packed=bins.packed[:, :n].contiguous(),
                         gauss_ids=None if bins.gauss_ids is None else bins.gauss_ids[:n])


@pytest.mark.parametrize("case", sorted(CASES))
def test_live_rows_blend_as_the_whole_list(case):
    """The plain K2's image, alpha and training planes, and the plain K3's
    per-splat rows, from the plain list and from its live rows alone, bit
    for bit; the dead rows' per-entry gradients are zero."""
    f16, with_ids, tpg, mpt, exact = CASES[case]
    scene = _scene()
    args = _args(scene, f16, with_ids, tpg, mpt, exact)
    full = ptiles.bin_gaussians_packed_plain(*args)
    n = _n_live(args)
    assert 0 < n < full.packed.shape[1]
    if mpt == 4:
        assert int(full.counts.max()) == 4 and int(full.n_dropped) > 0
    cut = _cut(full, n)
    d = scene[2].shape[-1]
    outs = [pflat.rasterize_flat_plain(b.packed, b.starts, b.counts, W, H, TILE, d, f16,
                                       with_state=True) for b in (full, cut)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    if f16:
        return
    rng = np.random.default_rng(3)
    v_img = t(rng.normal(size=(H, W, d)).astype(np.float32))
    v_alpha = t(rng.normal(size=(H, W, 1)).astype(np.float32))
    (e_full, s_full), (e_cut, s_cut) = (
        pflat.rasterize_flat_bwd_plain(b.packed, b.starts, b.counts, b.gauss_ids,
                                       scene[0].shape[0], v_img, v_alpha, W, H, TILE, d)
        for b in (full, cut))
    assert torch.equal(s_full, s_cut) and torch.count_nonzero(s_full) > 0
    assert torch.equal(e_full[:, :n], e_cut) and not e_full[:, n:].any()


def test_the_cpu_takes_the_plain_binning_and_counts_it():
    """bin_gaussians_packed on the CPU: the plain list (every field), no K7
    launch; the request counts the route once, the rows the plain code
    sorts (N*TPG) and the depth scalar's upload."""
    args = _args(_scene(), False, True, 9, 1024, True)
    launches = ptiles.bin_gaussians_packed.launches
    with pprof.recording() as rec, pprof.request():
        bins = ptiles.bin_gaussians_packed(*args)
    (req,) = rec.resolve()
    ref = ptiles.bin_gaussians_packed_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(bins, ref))
    assert req.counts == {"bin_fused": 1, "bin_rows": 400 * 9, "host_syncs": 1}
    assert ptiles.bin_gaussians_packed.launches == launches


@pytest.mark.parametrize("group", [2, 3, 5])
def test_the_k5_route_blends_the_live_rows_as_the_whole_list(monkeypatch, group):
    """With WM_RASTER_GROUP > 1 blend_flat clamps the segments to K5's
    group windows (group_windows, against the list's length M): from the
    plain list and from its live rows alone, the clamped starts and counts,
    the entries the windows cut, the blend order and the image are the
    same, bit for bit. The scene is crowded toward the first tiles, so that
    every group size has a group that overflows its window and, on the live
    rows, a group with entries whose window the clamp against M moves."""
    monkeypatch.setenv("WM_RASTER_GROUP", str(group))
    monkeypatch.setenv("WM_RASTER_CHUNK", "128")
    scene = list(_scene(1500))
    scene[0] = scene[0] * 0.7
    args = _args(scene, False, True, 9, 4, True)
    full = ptiles.bin_gaussians_packed_plain(*args)
    n = _n_live(args)
    cut = _cut(full, n)
    outs, orders = [], []
    for b in (full, cut):
        orders.append(torch.empty(TW * TH, dtype=torch.int64))
        outs.append(prast.blend_flat(b, W, H, TILE, scene[2].shape[-1], False, 4,
                                     with_state=True, order_out=orders[-1]))
    (o_full, s_full, c_full, d_full), (o_cut, s_cut, c_cut, d_cut) = outs
    assert all(torch.equal(a, b) for a, b in zip(o_full, o_cut))
    assert torch.equal(s_full, s_cut) and torch.equal(c_full, c_cut)
    assert torch.equal(d_full, d_cut) and int(d_full) > int(full.n_dropped)
    assert torch.equal(*orders)
    win = (group + 1) * 128                 # group_windows' window at 4 a tile
    m_pad = n + (-n) % 128 + max(0, win - n)
    firsts = cut.starts.long()[::group]
    moved = [int(full.counts[g * group:(g + 1) * group].sum()) > 0
             for g in torch.nonzero((firsts // 128) * 128 > m_pad - win).flatten()]
    assert any(moved)


# --- K7's wrapper through a stand-in launch ------------------------------------

_CTYPES = {torch.int64: ctypes.c_int64, torch.int32: ctypes.c_int32,
           torch.float32: ctypes.c_float}


def _at(ptr, n, dtype):
    """The n elements of `dtype` at address ptr, as a tensor sharing them."""
    if n == 0:
        return torch.empty(0, dtype=dtype)
    return torch.frombuffer((_CTYPES[dtype] * n).from_address(ptr), dtype=dtype)


def _keys_entry(m2d, rad, dep, ca, cb, cc, lvl, sa, sb, sc, sl, keys, aux, n, n_part,
                ts, tw, th, tpg, db, slot_bits):
    """bin_flat_keys emulated: the live slots' 64-bit keys (tile << db |
    depth_q) << slot_bits | slot (reversed: the emit entry must sort them),
    their count and the drops past TPG."""
    assert (n * tpg - 1).bit_length() == slot_bits
    assert 1 <= n_part <= ptiles._RANGE_BLOCKS
    ct = None
    if ca is not None:
        ct = tuple(_at(p, (n - 1) * s + 1, torch.float32)[::s]
                   for p, s in ((ca, sa), (cb, sb), (cc, sc), (lvl, sl)))
    m2d = _at(m2d, 2 * n, torch.float32).view(n, 2)
    rad = _at(rad, 2 * n, torch.int32).view(n, 2)
    key, n_cover, valid = ptiles._isect_keys(m2d, rad, _at(dep, n, torch.float32), ts,
                                             tw, th, tpg, db, ct)
    slot = torch.arange(tpg * n).view(tpg, n)
    live = ((key.long() << slot_bits) | slot)[(key >> db) < tw * th]
    _at(keys, live.numel(), torch.int64)[:] = live.flip(0)
    _at(aux, 2, torch.int64)[:] = torch.stack(
        [torch.tensor(live.numel()), ptiles._lost_to_tpg(n_cover, valid, tpg)])


def _emit_entry(keys, sorted_keys, temp, temp_bytes, end_bit, planes, strides, packed, ids,
                starts, counts, aux, n_live, n, V, db, slot_bits, n_tiles, mpt):
    """bin_flat_emit emulated: the sort over end_bit bits, the payload
    gathered from each plane where it lies, the ids, the segments and the
    clamp's cut."""
    live = torch.sort(_at(keys, n_live, torch.int64)).values
    assert temp_bytes >= 1 and int(live.max()).bit_length() <= end_bit
    _at(sorted_keys, n_live, torch.int64)[:] = live
    g = (live & ((1 << slot_bits) - 1)) % n
    for c in range(V):
        plane = _at(planes[c], (n - 1) * strides[c] + 1, torch.int32)[::strides[c]]
        _at(packed + 4 * c * n_live, n_live, torch.int32)[:] = plane[g]
    if ids is not None:
        _at(ids, n_live, torch.int32)[:] = g.int()
    s, c, cut = ptiles._segments(live >> slot_bits, torch.arange(n_tiles + 1), db, mpt)
    _at(starts, n_tiles, torch.int32)[:] = s.int()
    _at(counts, n_tiles, torch.int32)[:] = c.int()
    _at(aux, 2, torch.int64)[1] += cut


def _k7_standin(monkeypatch):
    """The kernels' device check answers "the card" and K7's C entries run
    as _keys_entry and _emit_entry -> the list of the entries called."""
    calls = []

    def standin(src, fn, argtypes, dev, *a):
        assert src == "bin_flat" and len(a) == len(argtypes)
        calls.append(fn)
        with pprof.recording():         # the emulation's own counts stay out
            (_keys_entry if fn == "bin_flat_keys" else _emit_entry)(*a)

    monkeypatch.setattr(ptiles, "check_device", lambda x, fn: False)
    monkeypatch.setattr(ptiles, "launch", standin)
    monkeypatch.setattr(ptiles, "_sort_bytes", lambda n, end_bit: 8 * n)
    return calls


@pytest.mark.parametrize("case", sorted(CASES) + ["no_valid_splat"])
def test_k7_wrapper_gives_the_plain_live_prefix(monkeypatch, case):
    """_bin_flat with its C entries emulated: each entry gets as many
    arguments as its signature names, the conic planes their strides, and
    the list is the plain list's live prefix, every field; one launch
    counted, the live count's readback counted as the camera's sync."""
    calls = _k7_standin(monkeypatch)
    f16, with_ids, tpg, mpt, exact = CASES.get(case, CASES["f32_ids_tpg9"])
    scene = list(_scene())
    if case == "no_valid_splat":
        scene[4] = torch.zeros_like(scene[4])
    args = _args(scene, f16, with_ids, tpg, mpt, exact)
    launches = ptiles.bin_gaussians_packed.launches
    with pprof.recording() as rec, pprof.request():
        k7 = ptiles.bin_gaussians_packed(*args)
    (req,) = rec.resolve()
    plain = ptiles.bin_gaussians_packed_plain(*args)
    n = _n_live(args)
    assert k7.packed.shape == (plain.packed.shape[0], n)
    for a, b in zip(k7, _cut(plain, n)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert calls == (["bin_flat_keys", "bin_flat_emit"] if n else ["bin_flat_keys"])
    assert req.counts == {"bin_fused": 1, "host_syncs": 1, "bin_rows": n}
    assert ptiles.bin_gaussians_packed.launches == launches + 1


# --- the benchmark's readers of the counters ------------------------------------

METRICS = Path(__file__).resolve().parents[1] / "wmbench" / "metrics"


@pytest.mark.parametrize("name,counter", [
    ("bin_fused.recon", "bin_fused"), ("bin_fused.train", "bin_fused"),
    ("bin_rows.recon", "bin_rows"), ("bin_rows.train", "bin_rows")])
def test_the_counter_readers_read_the_window(name, counter):
    """Each reader gives the counter's mean a request over the window, and
    nothing where the program counted none."""
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.SOURCE, mod.UNIT) == ("program_counter",
                                      "count" if counter == "bin_fused" else "rows")
    for n in (4, 6):
        with pprof.request([], start=True):
            pprof.count(counter, n)
    assert mod.read(SimpleNamespace(spans=[{}, {}])) == 5
    with pprof.request([], start=True):
        pprof.count("host_syncs")
    assert mod.read(SimpleNamespace(spans=[{}])) is None
