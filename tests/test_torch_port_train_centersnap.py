"""The CenterSnap trainer of the port against the JAX package's.

  * AdamWCosine against optax.adamw(cosine_decay_schedule) over 3 updates
    on the same gradients (one leaf the loss never reaches, a horizon of 2
    so the schedule clamps): params, mu and nu within 1e-6 + 1e-5 relative;
  * checkpoints: one written by the JAX package (2 optax updates) resumed
    by the port, one written by the port resumed by JAX (its own
    load_train_state and its restore's unflatten, with the optimizer's
    empty middle state closed up: JAX's restore_opt_state raises a KeyError
    on the trainer's own optimizer), the next update equal on both sides;
  * the loader: the same batches, keys in the same order, for one seed
    (the tarfile path on both sides; the port's native path at one thread);
  * preprocessing, visualize, the numpy PNG reader against PIL (filters
    0-4, RGB and RGBA), the wds_tools twin against tools/wds_tools.py, the
    CLI twin's flags against tools/train.py's, all exact;
  * the CLI twin for 2 steps on tiny shards on the CPU, a resume, and
    --arch res_fpn.
"""

import dataclasses
import io
import json
import struct
import sys
import tarfile
import zlib

import jax
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from torch_port_helpers import close, normal, uniform
from hunyuanworld_mirror_tpu import preprocessing as jprep
from hunyuanworld_mirror_tpu.training import checkpoint as jckpt
from hunyuanworld_mirror_tpu.training import data as jdata
from hunyuanworld_mirror_tpu.training import visualize as jvis
from hunyuanworld_mirror_tpu_torch import convert
from hunyuanworld_mirror_tpu_torch import preprocessing as pprep
from hunyuanworld_mirror_tpu_torch import train as ptrain
from hunyuanworld_mirror_tpu_torch import wds_tools as pwds
from hunyuanworld_mirror_tpu_torch.models import centersnap as pcs
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.training import checkpoint as pckpt
from hunyuanworld_mirror_tpu_torch.training import data as pdata
from hunyuanworld_mirror_tpu_torch.training import native_loader as pnative
from hunyuanworld_mirror_tpu_torch.training import trainer as ptrainer
from hunyuanworld_mirror_tpu_torch.training import visualize as pvis
from hunyuanworld_mirror_tpu_torch.training.tb_writer import png_encode

TINY = dict(img_size=32, patch_size=16, embed_dim=32, trunk_depth=2, trunk_heads=2,
            heatmap_features=16)
LR, WD = 1e-2, 0.05


def _model(seed=0):
    m = pcs.CenterSnap(pcs.CenterSnapConfig(**TINY))
    pnn.init_weights(m, torch.Generator().manual_seed(seed))
    return m


def _grads(model, seed):
    """Seeded gradients for every JAX leaf but the pose token's embedder
    (which the loss never reaches without the pose prior: None here, zeros
    for optax)."""
    rng = np.random.default_rng(seed)
    out = {}
    for leaf in convert.jax_leaves(model):
        p = model.get_parameter(leaf.name)
        out[leaf.name] = (None if "pose_embed" in leaf.name else
                          torch.tensor(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return out


def _set_grads(model, grads):
    for name, g in grads.items():
        model.get_parameter(name).grad = None if g is None else g.clone()


def _jax_grads(model, grads):
    return convert.to_jax_tree(model, {
        n: torch.zeros_like(model.get_parameter(n)) if g is None else g
        for n, g in grads.items()})


def _close_trees(a, b, err_msg=""):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        close(x, y, 1e-6, 1e-5, err_msg=err_msg)


def _tx(decay_steps):
    return optax.adamw(optax.cosine_decay_schedule(LR, decay_steps), weight_decay=WD)


def _jit_update(tx):
    """params, state <- one optax update, compiled once."""
    def update(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s
    return jax.jit(update)


def test_adamw_cosine_matches_optax_over_3_steps():
    model = _model()
    params = convert.to_jax_tree(model)
    tx = _tx(2)
    state = tx.init(params)
    update = _jit_update(tx)
    opt = ptrainer.AdamWCosine(model, LR, 2, WD)
    for step in range(3):
        grads = _grads(model, step)
        _set_grads(model, grads)
        opt.step()
        params, state = update(_jax_grads(model, grads), state, params)
        _close_trees(convert.to_jax_tree(model), params, f"params after {step + 1}")
        adam_count, sched_count, mu, nu = opt.export_state()
        assert adam_count == sched_count == int(state[0].count) == int(state[2].count)
        _close_trees(convert.to_jax_tree(model, mu), state[0].mu, "mu")
        _close_trees(convert.to_jax_tree(model, nu), state[0].nu, "nu")
    assert ptrainer.cosine_decay(LR, 2, 5) == 0.0


def test_jax_checkpoint_resumes_in_port(tmp_path):
    src = _model(seed=1)
    params = convert.to_jax_tree(src)
    tx = _tx(4)
    update = _jit_update(tx)
    state = tx.init(params)
    for step in range(2):
        params, state = update(_jax_grads(src, _grads(src, step)), state, params)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params(path, params, step=2, opt_state=state)

    model = _model(seed=2)
    opt = ptrainer.AdamWCosine(model, LR, 4, WD)
    tree, step = pckpt.load_train_state(path)
    convert.load_jax_tree(model, tree)
    assert step == 2 and pckpt.restore_opt_state(path, model, opt)
    assert opt.count == 2
    grads = _grads(model, 7)
    _set_grads(model, grads)
    opt.step()
    params, state = update(_jax_grads(model, grads), state, params)
    _close_trees(convert.to_jax_tree(model), params, "params after the resumed update")
    _close_trees(convert.to_jax_tree(model, opt.export_state()[2]), state[0].mu, "mu")


def test_port_checkpoint_resumes_in_jax(tmp_path):
    model = _model(seed=3)
    opt = ptrainer.AdamWCosine(model, LR, 4, WD)
    for step in range(2):
        _set_grads(model, _grads(model, step))
        opt.step()
    path = str(tmp_path / "port.npz")
    pckpt.save_params(path, model, step=2, optimizer=opt)

    params, step = jckpt.load_train_state(path)
    assert step == 2
    _close_trees(params, convert.to_jax_tree(model), "params")
    tx = _tx(4)
    template = tx.init(params)
    want = jckpt._flatten({"opt_state": jax.tree.map(np.asarray, template)})
    with np.load(path) as data:
        got = {k: data[k] for k in data.files if k.startswith("opt_state/")}
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
               for k in want)
    # JAX's restore: unflatten, take the leaves, rebuild on the template's
    # structure (the empty add_decayed_weights state between 0 and 2 closed up)
    flat = {k[len("opt_state/"):].replace("2/", "1/", 1) if k.startswith("opt_state/2/")
            else k[len("opt_state/"):]: v for k, v in got.items()}
    leaves = jax.tree.leaves(jckpt._unflatten(flat))
    state = jax.tree.unflatten(jax.tree.structure(template), leaves)
    assert int(state[0].count) == int(state[2].count) == 2

    grads = _grads(model, 9)
    _set_grads(model, grads)
    opt.step()
    params, state = _jit_update(tx)(_jax_grads(model, grads), state, params)
    _close_trees(convert.to_jax_tree(model), params, "params after the resumed update")


@pytest.mark.parametrize("arch", ["transformer", "res_fpn"])
def test_prepare_batch_matches_jax(arch):
    from hunyuanworld_mirror_tpu.training import trainer as jtrainer
    batch = {"rgb": uniform(1, (2, 16, 16, 3)), "heatmap": uniform(2, (2, 16, 16)),
             "pose_map": normal(3, (2, 12, 8, 8)), "depth": uniform(4, (2, 16, 16), 0, 30)}
    for keys in (("rgb", "heatmap", "pose_map", "depth"), ("rgb", "heatmap", "pose_map")):
        sub = {k: batch[k] for k in keys}
        ours = ptrainer._prepare_batch(ptrainer.TrainConfig(arch=arch), sub, "cpu")
        ref = jtrainer._prepare_batch(jtrainer.TrainConfig(arch=arch), sub)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            close(ours[k], ref[k], 1e-6, err_msg=k)


def _write_shards(tmp_path, n_shards=3, per=7, size=16):
    rng = np.random.default_rng(0)
    for s in range(n_shards):
        path = tmp_path / f"shard-{s:03d}.tar"
        with tarfile.open(path, "w") as tf:
            for i in range(per):
                key = f"{s:02d}{i:04d}"
                pose = rng.normal(size=(size // 2, size // 2, 12)).astype(np.float32)
                parts = {
                    "color.png": png_encode(rng.integers(0, 256, (size, size, 3), np.uint8)),
                    "meta.json": json.dumps({"i": i}).encode(),
                    "heatmap.npz": pwds._npz_bytes(heatmap=rng.uniform(size=(size, size)).astype(np.float32)),
                    "pose_map.npz": pwds._npz_bytes(abs_pose=pose)}
                for ext, data in parts.items():
                    pwds._add_bytes(tf, f"{key}.{ext}", data)
    return str(tmp_path / "shard-*.tar")


@pytest.mark.parametrize("epoch", [0, 1])
def test_loader_batches_match_jax_for_one_seed(tmp_path, epoch):
    pattern = _write_shards(tmp_path)
    kw = dict(batch_size=4, shuffle_buffer=5, seed=3, drop_keys=("meta",))
    ref = list(jdata.ShardedLoader(pattern, use_native="never", **kw).epoch(epoch))
    ours = list(pdata.ShardedLoader(pattern, use_native="never", **kw).epoch(epoch))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        assert list(a["__key__"]) == list(b["__key__"])
        for k in ("rgb", "heatmap", "pose_map"):
            np.testing.assert_array_equal(a[k], b[k])
    if pnative.available():   # one thread keeps the shard order
        native = list(pdata.ShardedLoader(pattern, use_native="always", native_threads=1,
                                          **kw).epoch(epoch))
        assert [list(b["__key__"]) for b in native] == [list(b["__key__"]) for b in ref]


def test_native_loader_builds_outside_native_dir():
    assert pnative.available(), "g++ should build native/tar_reader.cpp"
    assert pnative.library_path().parent == pnative.BUILD_DIR
    assert "build" in pnative.BUILD_DIR.parts and pnative.BUILD_DIR.name == "native"


def test_decoders_without_pil_or_cv2(monkeypatch):
    rgb = np.random.default_rng(1).integers(0, 256, (9, 13, 3), np.uint8)
    sample = {"__key__": "k", "color.png": png_encode(rgb)}
    with_pil = pdata.decode_sope_sample(sample)["rgb"]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(pdata.decode_sope_sample(sample)["rgb"], with_pil)
    assert pdata.decode_sope_sample({"__key__": "bad", "color.png": b"not a png"}) is None
    with pytest.raises(pdata.DecoderUnavailable):
        pdata.decode_sope_sample(dict(sample, **{"depth.exr": b"\x76\x2f\x31\x01"}))


def _png(arr: np.ndarray, ftype: int) -> bytes:
    """An 8-bit PNG of (H, W, C) uint8 with every row under filter `ftype`."""
    h, w, c = arr.shape
    bpp, raw = c, arr.reshape(h, w * c).astype(np.int64)
    rows = []
    for r in range(h):
        x, up = raw[r], raw[r - 1] if r else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - up
        elif ftype == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
            f = x - pred
        rows.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())

    def chunk(typ, payload):
        return (struct.pack(">I", len(payload)) + typ + payload
                + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_read_png_matches_pil(ftype, channels):
    from PIL import Image
    arr = np.random.default_rng(ftype).integers(0, 256, (7, 11, channels), np.uint8)
    data = _png(arr, ftype)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(ref, arr[..., :3])
    np.testing.assert_array_equal(pdata.read_png(data), ref)


def test_read_png_pil_written_and_refused_kinds():
    from PIL import Image
    arr = (np.linspace(0, 255, 24 * 20 * 3) % 256).astype(np.uint8).reshape(24, 20, 3)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(pdata.read_png(buf.getvalue()), arr)
    buf = io.BytesIO()
    Image.fromarray(arr).convert("P").save(buf, format="PNG")
    with pytest.raises(pdata.DecoderUnavailable):
        pdata.read_png(buf.getvalue())


def test_preprocessing_and_visualize_match_jax():
    s = chip_smoke.synthetic_sope(np.random.default_rng(4), 48)
    args = (s["masks"], s["rotations"], s["translations"], s["sizes"], s["K"])
    heat, pose = pprep.make_targets(*args)
    rheat, rpose = jprep.make_targets(*args)
    np.testing.assert_array_equal(heat, rheat)
    np.testing.assert_array_equal(pose, rpose)
    peaks = pprep.extract_peaks(heat, min_distance=4)
    np.testing.assert_array_equal(peaks, jprep.extract_peaks(rheat, min_distance=4))
    assert len(peaks) >= 1
    poses, sizes = pprep.extract_poses_at_peaks(peaks, pose)
    rposes, rsizes = jprep.extract_poses_at_peaks(peaks, rpose)
    np.testing.assert_array_equal(np.stack(poses), np.stack(rposes))
    np.testing.assert_array_equal(np.stack(sizes), np.stack(rsizes))
    batch = {"rgb": s["rgb"][None].astype(np.float32) / 255, "heatmap": heat[None]}
    preds = {"heatmap": heat[None, ..., None], "pose_map": pose[None]}
    ours, ref = pvis.training_visuals(batch, preds), jvis.training_visuals(batch, preds)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_wds_tools_twin_matches_tools(tmp_path):
    import subprocess
    src = chip_smoke.write_sope_samples(tmp_path / "samples", 5, 32, seed=6)
    pwds.main(["convert", str(src), str(tmp_path / "ours"), "--shard-size", "2",
               "--gen-targets"])
    r = subprocess.run([sys.executable, "tools/wds_tools.py", "convert", str(src),
                        str(tmp_path / "ref"), "--shard-size", "2", "--gen-targets"],
                       capture_output=True, text=True,
                       cwd=str(chip_smoke.__file__).rsplit("/", 1)[0])
    assert r.returncode == 0, r.stderr
    ours = sorted((tmp_path / "ours").glob("*.tar"))
    ref = sorted((tmp_path / "ref").glob("*.tar"))
    assert [p.name for p in ours] == [p.name for p in ref] and len(ours) == 3
    for a, b in zip(ours, ref):
        sa, sb = list(jdata.iter_tar_samples(str(a))), list(jdata.iter_tar_samples(str(b)))
        assert [sorted(x) for x in sa] == [sorted(x) for x in sb]
        for x, y in zip(sa, sb):
            assert x["color.png"] == y["color.png"]
            for k in ("heatmap.npz", "pose_map.npz"):
                for u, v in zip(pdata.decode_npz_bytes(x[k]).values(),
                                jdata.decode_npz_bytes(y[k]).values()):
                    np.testing.assert_array_equal(u, v)
    pwds.main(["list", *map(str, ours)])
    pwds.main(["extract", str(ours[0]), str(tmp_path / "ext")])
    assert len(list((tmp_path / "ext").iterdir())) == 2 * 4   # 2 samples x 4 files


def _tools_train_config(monkeypatch, argv):
    import tools.train as tools_train
    from hunyuanworld_mirror_tpu.training import trainer as jtrainer
    seen = []
    monkeypatch.setattr(jtrainer, "train", lambda cfg: seen.append(cfg))
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    tools_train.main()
    return seen[0]


@pytest.mark.parametrize("argv", [
    [],
    ["--test-shards", "t-*.tar", "--batch-size", "4", "--epochs", "3", "--lr", "1e-4",
     "--weight-decay", "0.1", "--img-size", "256", "--patch-size", "14", "--depth-cond",
     "--ckpt", "c.npz", "--ckpt-every-epochs", "1", "--resume", "r.npz", "--seed", "5"],
    ["--arch", "res_fpn"]])
def test_cli_flags_and_defaults_match_tools_train(monkeypatch, argv):
    argv = ["--train-shards", "s-{000..003}.tar"] + argv
    ref = _tools_train_config(monkeypatch, argv)
    ours = ptrain.config(ptrain.parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert type(ours.model).__name__ == type(ref.model).__name__


def test_cli_twin_trains_resumes_and_runs_res_fpn_on_cpu(tmp_path):
    for split, n, seed in (("train", 4, 1), ("test", 2, 2)):
        src = chip_smoke.write_sope_samples(tmp_path / f"{split}_samples", n, 32, seed)
        pwds.main(["convert", str(src), str(tmp_path / split), "--shard-size", "2",
                   "--prefix", split, "--gen-targets"])
    ckpt = str(tmp_path / "cs.npz")
    base = ["--train-shards", str(tmp_path / "train" / "train-*.tar"),
            "--test-shards", str(tmp_path / "test" / "test-*.tar"),
            "--batch-size", "2", "--img-size", "32", "--epochs", "1",
            "--ckpt-every-epochs", "1", "--ckpt", ckpt]
    lines = []
    for extra, want in (([], [1, 2]), (["--resume", ckpt], [3, 4]),
                        (["--arch", "res_fpn", "--ckpt", str(tmp_path / "fpn.npz")], [1, 2])):
        steps = []
        ptrain.main(base + extra, device="cpu", log_fn=lines.append,
                    on_step=lambda s, loss, logs, marks: steps.append((s, float(loss))))
        assert [s for s, _ in steps] == want
        assert all(np.isfinite(v) for _, v in steps)
    assert any(line.startswith("resumed from") and line.endswith("at step 2") for line in lines)
    tests = [float(x.split("test loss ")[1].split()[0]) for x in lines if "test loss" in x]
    assert len(tests) == 3 and np.isfinite(tests).all()
    _, step = jckpt.load_train_state(ckpt)     # the JAX package reads the port's
    assert step == 4


def test_train_logs_scalars_and_images_to_tensorboard(tmp_path):
    from hunyuanworld_mirror_tpu_torch.training import tb_writer
    src = chip_smoke.write_sope_samples(tmp_path / "samples", 2, 32, seed=8)
    pwds.do_convert(str(src), str(tmp_path / "shards"), shard_size=2, gen_targets=True)
    cfg = ptrainer.TrainConfig(
        train_shards=str(tmp_path / "shards" / "shard-*.tar"), batch_size=2, epochs=1,
        log_every=1, vis_every=1, ckpt_path=str(tmp_path / "c.npz"),
        model=pcs.CenterSnapConfig(**TINY))
    ptrainer.train(cfg, log_fn=lambda *a: None, tb_logdir=str(tmp_path / "tb"),
                   device="cpu")
    events = str(next((tmp_path / "tb").glob("events.out.tfevents.*")))
    tags = {tag for _, values in tb_writer.read_scalars(events) for tag in values}
    assert {"loss/train", "loss/heatmap_loss", "loss/pose_loss"} <= tags
    images = {tag: img for _, tag, img in tb_writer.read_images(events)}
    assert set(images) == {"vis/heatmaps", "vis/bbox_overlay"}
    assert images["vis/heatmaps"].shape == (2 * 32, 3 * 32, 3)
    assert images["vis/bbox_overlay"].shape == (32, 2 * 32, 3)
