"""The demo server twin (`python -m hunyuanworld_mirror_tpu_torch.app`)
against the JAX package's app.py, on the CPU.

The routes, the multipart parser, the page and the example browser are
held to the JAX app's on the same inputs (strings equal); /out/ refuses
paths outside --workdir. One POST /run end to end at the tiny preset and
56 px: its depth equals infer.reconstruct's on the same images and model
(bit for bit), and the JAX app's run_inference, handed the port's
predictions as its forward's output, writes the same files under the same
names, byte for byte but scene.glb, whose points the two recompute from
depth in f32 each (its chunk layout equal, positions within 1e-5).
"""

import argparse
import importlib.util
import json
import struct
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from hunyuanworld_mirror_tpu_torch import app, infer
from hunyuanworld_mirror_tpu_torch.io import images as io_images

REPO = Path(__file__).resolve().parents[1]


def _jax_app():
    name = "wm_jax_app_for_port_tests"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REPO / "app.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _args(tmp_path, **kw):
    args = app.parse_args(["--workdir", str(tmp_path / "work"), "--examples",
                           str(tmp_path / "examples")])
    (tmp_path / "work").mkdir(exist_ok=True)
    vars(args).update(kw)
    return args


def _serve(demo):
    srv = app.DemoServer(("127.0.0.1", 0), demo)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _multipart(fields, files=()):
    b = "portboundary"
    parts = [f'--{b}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    for name, data in files:
        parts.append(f'--{b}\r\nContent-Disposition: form-data; name="images"; '
                     f'filename="{name}"\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{b}--\r\n".encode())
    return b"".join(parts), b


def _post(base, fields, files=(), path="/run"):
    body, b = _multipart(fields, files)
    req = urllib.request.Request(base + path, data=body, headers={
        "Content-Type": f"multipart/form-data; boundary={b}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _examples(tmp_path, n=2, size=56):
    rng = np.random.default_rng(0)
    paths = []
    for cat, scene in (("indoor", "room"), ("outdoor", "street")):
        d = tmp_path / "examples" / cat / scene
        d.mkdir(parents=True)
        for i in range(n):
            p = d / f"{i}.png"
            Image.fromarray((rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)).save(p)
            paths.append(str(p))
    (tmp_path / "examples" / "indoor" / "README").write_text("not a scene")
    return paths


def test_flags_and_defaults_match_jax(monkeypatch):
    """Every flag of app.py with its default; the examples directory is
    the reference repository's examples/ relative to where the app runs, and
    the work directory is under the temporary directory."""
    monkeypatch.setattr(sys, "argv", ["app.py"])
    ref, ours = vars(_jax_app().parse_args()), vars(app.parse_args([]))
    assert set(ours) == set(ref)
    for k in set(ref) - {"examples", "workdir"}:
        assert ours[k] == ref[k], k
    assert ours["examples"] == "examples" and Path(ours["workdir"]).name == "wm_demo"
    argv = ["--port", "1", "--host", "0.0.0.0", "--preset", "tiny", "--size", "56",
            "--ckpt", "c.npz", "--examples", "e", "--workdir", "w", "--rasterizer", "jax",
            "--max-views", "3"]
    monkeypatch.setattr(sys, "argv", ["app.py", *argv])
    assert vars(app.parse_args(argv)) == vars(_jax_app().parse_args())


def test_needs_a_gpu_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--workdir", str(tmp_path), "--port", "0"], serve=False)


def test_multipart_parser_matches_jax():
    body, b = _multipart({"example": "indoor/room", "conf": "35", "mask_sky": "on"},
                         [("a.png", b"\x89PNG\x00\x01"), ("b.jpg", b"jpegdata")])
    body += (f'--{b}\r\nContent-Disposition: form-data; name="images"; filename=""'
             f'\r\n\r\n\r\n--{b}\r\nContent-Disposition: form-data\r\n\r\nx\r\n').encode()
    assert app._parse_multipart(body, b) == _jax_app()._parse_multipart(body, b)
    fields, files = app._parse_multipart(body, b)
    assert fields == {"example": "indoor/room", "conf": "35", "mask_sky": "on"}
    assert [n for n, _ in files] == ["a.png", "b.jpg"]


def test_page_and_result_match_jax(tmp_path):
    _examples(tmp_path)
    jax_app = _jax_app()
    jax_app.STATE["args"] = _args(tmp_path)
    demo = app.Demo(_args(tmp_path), None, torch.device("cpu"))
    assert demo.list_examples() == jax_app.list_examples() == ["indoor/room",
                                                               "outdoor/street"]
    info = {"gallery": ["depth_00.png", "normal_00.png"], "views": 1, "elapsed": 1.25,
            "artifacts": {"glb": "scene.glb", "ply": "gaussians.ply",
                          "video": "rendered.mp4"}, "viewer": True}
    assert app.render_result("run_ab", info) == jax_app.render_result("run_ab", info)
    srv, base = _serve(demo)
    try:
        status, page = _get(base + "/")
        assert status == 200
        opts = "".join(f"<option>{e}</option>" for e in demo.list_examples())
        assert page.decode() == app._PAGE.format(examples=opts, result="")
    finally:
        srv.shutdown()
        srv.server_close()


def test_routes_and_traversal(tmp_path):
    """/health, /viewer (the port's own viewer.html), /out/ serving and
    its refusals, unknown routes, and POST /run without images or with an
    example that is not listed."""
    _examples(tmp_path)
    args = _args(tmp_path, preset="tiny")
    run = Path(args.workdir) / "run_x"
    run.mkdir()
    (run / "gaussians.splat").write_bytes(b"\x01" * 64)
    (run / "scene.glb").write_bytes(b"glTF....")
    sibling = tmp_path / "work2"
    sibling.mkdir()
    (sibling / "secret.txt").write_text("outside the workdir")
    (tmp_path / "secret.txt").write_text("outside the workdir")
    srv, base = _serve(app.Demo(args, None, torch.device("cpu")))
    try:
        assert _get(base + "/health") == (200, json.dumps({"ok": True, "model": "tiny"}).encode())
        status, page = _get(base + "/viewer?run=run_x")
        viewer = (REPO / "hunyuanworld_mirror_tpu_torch" / "io" / "viewer.html").read_bytes()
        assert status == 200 and page == viewer and b"<canvas" in page
        assert _get(base + "/out/run_x/gaussians.splat") == (200, b"\x01" * 64)
        assert _get(base + "/out/run_x/scene.glb")[0] == 200
        for bad in ("/out/../secret.txt", "/out/%2e%2e/secret.txt", "/out/../work2/secret.txt",
                    "/out/run_x", "/out/run_x/absent.png", "/nothing"):
            assert _get(base + bad)[0] == 404, bad
        assert _post(base, {"conf": "20"})[0] == 400
        assert _post(base, {"example": "../../secret"})[0] == 400
        assert _post(base, {"example": "indoor"})[0] == 400
        assert _post(base, {}, path="/other")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The app at the tiny preset and 56 px on the CPU, its model built once
    by main(), its predictions captured per request."""
    tmp = tmp_path_factory.mktemp("app")
    paths = _examples(tmp)
    srv = app.main(["--preset", "tiny", "--size", "56", "--port", "0", "--workdir",
                    str(tmp / "work"), "--examples", str(tmp / "examples")],
                   device="cpu", serve=False)
    demo, captured = srv.demo, []
    predict = demo.predict

    def capture(image_paths):
        captured.append(predict(image_paths))
        return captured[-1]

    demo.predict = capture
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}", paths, captured, tmp
    srv.shutdown()
    srv.server_close()


def _run_dir(srv, page):
    import re
    m = re.search(r"/out/(run_[0-9a-f]+)/", page)
    assert m, page
    return Path(srv.demo.args.workdir) / m.group(1)


def _glb_chunks(data):
    jlen = struct.unpack("<I", data[12:16])[0]
    return json.loads(data[20:20 + jlen]), data[20 + jlen + 8:]


def test_run_upload_matches_reconstruct_and_jax_files(served):
    srv, base, paths, captured, tmp = served
    files = [(Path(p).name, Path(p).read_bytes()) for p in paths[:2]]
    status, page = _post(base, {"conf": "20"}, files)
    assert status == 200 and "Result (2 views" in page
    run_dir = _run_dir(srv, page)
    imgs, preds, elapsed = captured[-1]
    assert elapsed > 0
    # the depth of infer.reconstruct on prepare_images of the same files
    ref_imgs = io_images.prepare_images(paths[:2], target_size=56)
    np.testing.assert_array_equal(imgs, ref_imgs)
    ref = infer.reconstruct(srv.demo.model, ref_imgs)
    np.testing.assert_array_equal(preds["depth"], ref["depth"].numpy())

    # the JAX app's postprocessing of the same predictions
    jax_app = _jax_app()
    jax_args = argparse.Namespace(**vars(srv.demo.args))
    jax_args.workdir = str(tmp / "jax_work")
    jax_app.STATE["args"] = jax_args
    jax_app.STATE["model"] = (None, None, lambda p, v: {k: v for k, v in preds.items()
                                                         if k != "pts3d"})
    run_id, info = jax_app.run_inference(paths[:2], {"conf": "20"})
    jax_dir = Path(jax_args.workdir) / run_id
    names = sorted(f.name for f in run_dir.iterdir())
    assert names == sorted(f.name for f in jax_dir.iterdir())
    assert names == sorted(["scene.glb", "gaussians.ply", "gaussians.splat", "cameras.json"]
                           + [f"{k}_{s:02d}.png" for s in range(2)
                              for k in ("depth", "normal", "input")])
    for name in names:
        if name != "scene.glb":
            assert (run_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
    (gj, bj), (gp, bp) = (_glb_chunks((jax_dir / "scene.glb").read_bytes()),
                          _glb_chunks((run_dir / "scene.glb").read_bytes()))
    acc = gj["accessors"][0]
    assert gp["accessors"][0]["count"] == acc["count"] and len(bp) == len(bj)
    np.testing.assert_allclose(np.frombuffer(bp, np.float32, acc["count"] * 3),
                               np.frombuffer(bj, np.float32, acc["count"] * 3), atol=1e-5)
    # the page shows the JAX app's result for the same run
    assert app.render_result(run_dir.name, {**info, "elapsed": elapsed}) in page


def test_run_example_and_video(served):
    """An example scene with the mask and mesh options, then an upload with
    video=on: rendered.mp4 written and linked."""
    srv, base, paths, captured, tmp = served
    status, page = _post(base, {"example": "outdoor/street", "mask_sky": "on",
                                "as_mesh": "on", "conf": "10"})
    assert status == 200 and "Result (2 views" in page
    np.testing.assert_array_equal(
        captured[-1][0], io_images.prepare_images(paths[2:], target_size=56))
    status, page = _post(base, {"video": "on", "effect": "spread"},
                         [(Path(p).name, Path(p).read_bytes()) for p in paths[:2]])
    assert status == 200 and "rendered.mp4" in page and "<video" in page
    assert (_run_dir(srv, page) / "rendered.mp4").stat().st_size > 0
