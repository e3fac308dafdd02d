"""Live in-training splat viewer.

A copy of hunyuanworld_mirror_tpu/training/live_viewer.py (the port
imports nothing of the JAX package): a standard-library HTTP sidecar that
serves the port's own copy of the WebGL2 viewer (io/viewer.html in live
mode), which polls a version-stamped status endpoint and fetches the
latest `.splat` snapshot whenever the trainer publishes one.

Endpoints:
  /              -> viewer.html in live mode
  /viewer        -> same
  /out/<run>/live.splat       -> latest snapshot (run segment ignored)
  /out/<run>/live_status.json -> {"version", "step", "loss", "num_gs"}
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np


class LiveViewer:
    """Publishes splat snapshots from an optimization loop and serves them.

    Usage:
        lv = LiveViewer(out_dir)          # prints the URL, server is live
        lv.update(splats, step, loss)     # called periodically by the trainer
        lv.close()
    """

    def __init__(self, out_dir: str, port: int = 0, host: str = "127.0.0.1"):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._version = 0
        self._write_status(step=0, loss=float("nan"), num_gs=0)

        viewer_html = (Path(__file__).resolve().parents[1] / "io"
                       / "viewer.html").read_text()
        out_dir_p = self.out_dir

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):  # quiet
                pass

            def _send(self, body, ctype="text/html", code=200):
                data = body if isinstance(body, bytes) else body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path in ("/", "/viewer"):
                    self._send(viewer_html.replace(
                        'PARAMS.get("mode") || "splat"',
                        'PARAMS.get("mode") || "live"'))
                elif path.startswith("/out/"):
                    # the sidecar serves one run: only the basename counts
                    name = os.path.basename(path)
                    p = out_dir_p / name
                    if (name not in ("live.splat", "live_status.json")
                            or not p.is_file()):
                        self._send("not found", code=404)
                        return
                    ctype = ("application/json" if name.endswith(".json")
                             else "application/octet-stream")
                    self._send(p.read_bytes(), ctype)
                else:
                    self._send("not found", code=404)

        self._srv = HTTPServer((host, port), Handler)
        self.port = self._srv.server_address[1]
        self.url = f"http://{host}:{self.port}/viewer?run=live"
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _write_status(self, step: int, loss: float, num_gs: int):
        tmp = self.out_dir / "live_status.json.tmp"
        tmp.write_text(json.dumps({
            "version": self._version, "step": int(step),
            "loss": None if loss != loss else float(loss),
            "num_gs": int(num_gs)}))
        os.replace(tmp, self.out_dir / "live_status.json")

    def update(self, splats: dict, step: int, loss: float) -> None:
        """Publish a snapshot. `splats` holds ACTIVATED means/quats(wxyz)/
        scales/opacities/sh arrays (dead slots already filtered)."""
        from ..io import ply as io_ply
        sh = np.asarray(splats["sh"])
        sh_dc = sh[:, 0] if sh.ndim == 3 else sh
        tmp = self.out_dir / "live.splat.tmp"
        io_ply.save_splat(tmp, splats["means"], splats["scales"],
                          splats["quats"], splats["opacities"], sh_dc)
        os.replace(tmp, self.out_dir / "live.splat")  # atomic swap
        self._version += 1
        self._write_status(step, loss, len(np.asarray(splats["means"])))

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
