"""WorldMirror demo server on one NVIDIA GPU (the port's twin of app.py).

    python -m hunyuanworld_mirror_tpu_torch.app [--port 7860] [--host 127.0.0.1]
        [--preset large|base|small|tiny] [--size 518] [--ckpt params.npz]
        [--examples examples] [--workdir $TMPDIR/wm_demo]
        [--rasterizer pallas|jax] [--max-views 8]

A dependency-free stdlib http.server app (no Gradio) with the reference
demo's workflow:

  GET  /            example browser + upload form + options
  POST /run         run inference (example dir or uploaded images)
  GET  /out/...     result artifacts (PNGs, GLB, PLY, splat, mp4)
  GET  /viewer      the in-browser WebGL viewer (io/viewer.html)
  GET  /health      {"ok": true, "model": <preset>}

The model loads once, on CUDA unless main() is given another device, with
bf16 parameters (`--ckpt`, an npz checkpoint in the JAX package's layout,
or random weights from seed 0); one request at a time runs the forward
with the render on (the attention and rasterizer kernels; `--rasterizer
jax` renders through the dense-bin kernel). Each request writes, under
`--workdir`/run_<ms>/: depth_XX.png, normal_XX.png, input_XX.png,
scene.glb (pts3d recomputed from depth and cameras, the confidence
percentile, edge masks and the optional sky mask of the form), and with
the Gaussian head gaussians.ply, gaussians.splat, cameras.json and, with
the form's `video`, rendered.mp4 (cv2).
"""

import argparse
import glob as globlib
import html
import json
import os
import re
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import infer, resolve_device
from .io import images as io_images
from .io import ply as io_ply
from .io import render as render_lib
from .io import scene as scene_lib
from .models.worldmirror import WorldMirror, WorldMirrorConfig
from .training import checkpoint as ckpt_lib
from .utils import geometry

VIEWER = Path(__file__).resolve().parent / "io" / "viewer.html"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="WorldMirror demo server (GPU)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--preset", choices=["large", "base", "small", "tiny"],
                   default="large")
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--ckpt", default=None)
    # the reference repository's examples/ (category/scene/*.png)
    p.add_argument("--examples", default="examples")
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(), "wm_demo"))
    p.add_argument("--rasterizer", choices=["jax", "pallas"], default="pallas")
    p.add_argument("--max-views", type=int, default=8)
    return p.parse_args(argv)


def build_model(args: argparse.Namespace, device) -> WorldMirror:
    """The preset's model at --size on `device`, bf16 parameters."""
    cfg = WorldMirrorConfig(img_size=args.size, rasterizer_impl=args.rasterizer,
                            **infer.PRESETS[args.preset])
    if args.ckpt:
        params = ckpt_lib.load_params(args.ckpt)
    else:
        print("WARNING: random weights (pass --ckpt for real outputs)")
        params = None
    return infer.load_model(cfg, params, device)


class Demo:
    """What one server answers with: its options, the model on its device
    (built once) and the lock that lets one request at a time use it."""

    def __init__(self, args: argparse.Namespace, model: Optional[WorldMirror],
                 device: torch.device):
        self.args, self.model, self.device = args, model, device
        self.lock = threading.Lock()

    def predict(self, image_paths: List[str]):
        """Image files -> (images (1, S, H, W, 3), numpy predictions with
        pts3d recomputed from depth and cameras, forward seconds: wall time
        up to the predictions on the host)."""
        imgs = io_images.prepare_images(image_paths[:self.args.max_views],
                                        target_size=self.args.size)
        t0 = time.time()
        out = infer.reconstruct(self.model, imgs)
        preds = infer.numpy_preds(out)
        elapsed = time.time() - t0
        # pts3d recomputed from predicted depth + cameras (reference app.py:148-151)
        with torch.no_grad():
            world, _, _ = geometry.depth_to_world_coords_points(
                out["depth"][0, ..., 0].float(), out["camera_poses"][0].float(),
                out["camera_intrs"][0].float())
        preds["pts3d"] = world[None].cpu().numpy()
        return imgs, preds, elapsed

    def run_inference(self, image_paths: List[str], opts: Dict[str, str]):
        """One reconstruction -> (run id, what the result page shows); its
        files go to --workdir/<run id>/."""
        args = self.args
        run_id = f"run_{int(time.time() * 1000):x}"
        out_dir = Path(args.workdir) / run_id
        out_dir.mkdir(parents=True, exist_ok=True)

        imgs, preds, elapsed = self.predict(image_paths)
        S, H, W = imgs.shape[1:4]
        c2w = preds["camera_poses"][0]
        K = preds["camera_intrs"][0]

        gallery = []
        for s in range(S):
            io_ply.save_depth_png(out_dir / f"depth_{s:02d}.png",
                                  preds["depth"][0, s, ..., 0])
            gallery.append(f"depth_{s:02d}.png")
            if "normals" in preds:
                io_ply.save_normal_png(out_dir / f"normal_{s:02d}.png",
                                       preds["normals"][0, s])
                gallery.append(f"normal_{s:02d}.png")
            io_ply.save_image_png(out_dir / f"input_{s:02d}.png", imgs[0, s])

        scene_lib.predictions_to_glb(
            {**preds, "images": imgs}, str(out_dir / "scene.glb"),
            conf_percent=float(opts.get("conf", 20.0)),
            mask_sky=opts.get("mask_sky") == "on",
            as_mesh=opts.get("as_mesh") == "on")

        artifacts = {"glb": "scene.glb"}
        if "splats" in preds:
            infer.export_gaussians(preds["splats"], out_dir)
            artifacts["ply"] = "gaussians.ply"
            artifacts["splat"] = "gaussians.splat"
            # cameras.json feeds the in-browser viewer's frusta overlay
            with open(out_dir / "cameras.json", "w") as f:
                json.dump([{"c2w": c2w[s].tolist(), "K": K[s].tolist(),
                            "width": W, "height": H} for s in range(S)], f)
            if opts.get("video") == "on":
                render_lib.render_interpolated_video(
                    preds, W, H, str(out_dir / "rendered.mp4"),
                    impl=args.rasterizer, effect=opts.get("effect") or None,
                    device=self.device)
                artifacts["video"] = "rendered.mp4"

        return run_id, {"gallery": gallery, "artifacts": artifacts,
                        "views": S, "elapsed": elapsed,
                        "viewer": "splats" in preds}

    def list_examples(self) -> List[str]:
        """The example scenes, "category/scene", under --examples."""
        root = self.args.examples
        out = []
        if os.path.isdir(root):
            for cat in sorted(os.listdir(root)):
                cdir = os.path.join(root, cat)
                if os.path.isdir(cdir):
                    for scene in sorted(os.listdir(cdir)):
                        if os.path.isdir(os.path.join(cdir, scene)):
                            out.append(f"{cat}/{scene}")
        return out


_PAGE = """<!doctype html><html><head><title>WorldMirror</title>
<style>body{{font-family:sans-serif;max-width:960px;margin:2em auto}}
img{{max-width:220px;margin:4px;border:1px solid #ccc}}
.row{{display:flex;flex-wrap:wrap}}</style></head><body>
<h1>WorldMirror demo</h1>
<form method="post" action="/run" enctype="multipart/form-data">
<p>Example scene: <select name="example"><option value=""></option>{examples}
</select> &nbsp;or upload images: <input type="file" name="images" multiple></p>
<p>conf percentile <input name="conf" value="20" size="3">
<label><input type="checkbox" name="mask_sky"> mask sky</label>
<label><input type="checkbox" name="as_mesh"> GLB as mesh</label>
<label><input type="checkbox" name="video"> render video</label>
effect <select name="effect"><option value=""></option>
<option>twister</option><option>rain</option><option>spread</option></select>
</p><p><button type="submit">Reconstruct</button></p></form>
{result}</body></html>"""


def render_result(run_id: str, info: Dict) -> str:
    items = "".join(
        f'<img src="/out/{run_id}/{html.escape(f)}">' for f in info["gallery"])
    links = " | ".join(
        f'<a href="/out/{run_id}/{html.escape(v)}">{html.escape(k)}</a>'
        for k, v in info["artifacts"].items())
    vid = ""
    if "video" in info["artifacts"]:
        vid = (f'<video controls width="480" '
               f'src="/out/{run_id}/{info["artifacts"]["video"]}"></video>')
    viewer = ""
    if info.get("viewer"):
        # the interactive WebGL viewer (io/viewer.html, self-contained):
        # splat mode + GLB scene mode
        viewer = (f'<p><a href="/viewer?run={run_id}" target="_blank">'
                  f'open 3D viewer</a> · '
                  f'<a href="/viewer?run={run_id}&mode=glb" target="_blank">'
                  f'GLB scene view</a></p>'
                  f'<iframe src="/viewer?run={run_id}" width="100%" '
                  f'height="480" style="border:1px solid #888"></iframe>')
    return (f"<h2>Result ({info['views']} views, "
            f"{info['elapsed']:.1f}s forward)</h2>"
            f"<p>Downloads: {links}</p>{viewer}"
            f"<div class='row'>{items}</div>{vid}")


_CONTENT_TYPES = {".png": "image/png", ".glb": "model/gltf-binary",
                  ".mp4": "video/mp4", ".ply": "application/octet-stream",
                  ".splat": "application/octet-stream"}


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *a):
        pass

    @property
    def demo(self) -> Demo:
        return self.server.demo

    def _send(self, body, ctype="text/html", code=200):
        data = body if isinstance(body, bytes) else body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _page(self, result: str = "") -> str:
        opts = "".join(f'<option>{html.escape(e)}</option>'
                       for e in self.demo.list_examples())
        return _PAGE.format(examples=opts, result=result)

    def do_GET(self):
        if self.path == "/" or self.path.startswith("/?"):
            self._send(self._page())
        elif self.path.startswith("/out/"):
            rel = urllib.parse.unquote(self.path[len("/out/"):])
            base = Path(self.demo.args.workdir).resolve()
            p = (base / rel).resolve()
            if not p.is_relative_to(base) or not p.is_file():
                self._send("not found", code=404)
                return
            self._send(p.read_bytes(),
                       _CONTENT_TYPES.get(p.suffix, "application/octet-stream"))
        elif self.path.startswith("/viewer"):
            self._send(VIEWER.read_text())
        elif self.path == "/health":
            self._send(json.dumps({"ok": True, "model": self.demo.args.preset}),
                       "application/json")
        else:
            self._send("not found", code=404)

    def do_POST(self):
        if self.path != "/run":
            self._send("not found", code=404)
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        m = re.search("boundary=([^;]+)", ctype)
        fields, files = _parse_multipart(body, m.group(1)) if m else ({}, [])
        if fields.get("video") == "on":
            try:
                render_lib.require_cv2("the video option")
            except SystemExit as e:
                self._send(str(e), code=400)
                return

        args = self.demo.args
        image_paths = []
        if fields.get("example"):
            if fields["example"] not in self.demo.list_examples():
                self._send("unknown example", code=400)
                return
            d = os.path.join(args.examples, fields["example"])
            for ext in io_images.IMAGE_EXTS:
                image_paths.extend(globlib.glob(os.path.join(d, ext)))
            image_paths = sorted(set(image_paths))
        elif files:
            up = Path(tempfile.mkdtemp(prefix="upload_", dir=args.workdir))
            for i, (name, data) in enumerate(files):
                p = up / f"{i:03d}_{os.path.basename(name)}"
                p.write_bytes(data)
                image_paths.append(str(p))

        if not image_paths:
            self._send("no images provided", code=400)
            return
        with self.demo.lock:
            run_id, info = self.demo.run_inference(image_paths, fields)
        self._send(self._page(render_result(run_id, info)))


def _parse_multipart(body: bytes, boundary: str):
    """Tiny multipart/form-data parser (the cgi module is gone in 3.13+)."""
    fields, files = {}, []
    delim = b"--" + boundary.encode()
    for part in body.split(delim):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, data = part.split(b"\r\n\r\n", 1)
        head = head.decode(errors="replace")
        name_m = re.search(r'name="([^"]*)"', head)
        file_m = re.search(r'filename="([^"]*)"', head)
        if not name_m:
            continue
        if file_m and file_m.group(1):
            if data:
                files.append((file_m.group(1), data))
        else:
            fields[name_m.group(1)] = data.decode(errors="replace")
    return fields, files


class DemoServer(ThreadingHTTPServer):
    """The HTTP server of one Demo (`Handler` reads it as `self.server.demo`)."""

    def __init__(self, address, demo: Demo):
        super().__init__(address, Handler)
        self.demo = demo


def main(argv: Optional[List[str]] = None, device=None, serve: bool = True):
    """Build the model and serve it; `device` as for infer.run (CUDA unless
    named). With serve=False the server is returned bound but not started
    (--port 0 binds a free port: `server_address[1]`)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    os.makedirs(args.workdir, exist_ok=True)
    print(f"loading model (preset={args.preset}, size={args.size}) ...")
    srv = DemoServer((args.host, args.port), Demo(args, build_model(args, dev), dev))
    if not serve:
        return srv
    print(f"demo at http://{args.host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
