"""The cell rehearsed on the CPU at a tiny size through the harness's own
code, the result line's shape, the exit without a card, and a throwaway
cell added by files alone."""

import hashlib
import json
import os
import subprocess
import sys

from wmbench import run
from wmbench.tests import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_rehearsal_result_shape():
    res = run.run_cell(tiny.parts(), 2 ** 31 + 99, 1.0, False, "cpu", log=lambda *_: None)
    keys = list(res)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks" and len(keys) == 6
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "recon_ms_p90", "setup_s"}
    assert res["device"]["platform"] == "cpu"
    assert set(res["checks"]) == set(tiny.parts().limits)
    json.dumps(res)


def test_rehearsal_traced():
    res = run.run_cell(tiny.parts(), 5, 0.5, True, "cpu", log=lambda *_: None)
    assert list(res)[:5] == RESULT_KEYS and list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["metrics"] == {}   # no card: no device metric is read on the CPU


def test_exits_without_a_card():
    if __import__("torch").cuda.is_available():
        return
    p = subprocess.run([sys.executable, "-m", "wmbench.run", "--workload", tiny.CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(tiny.REPO)})
    assert p.returncode == 2 and p.stdout == ""


def test_exits_in_a_checkout_without_the_program(tmp_path):
    tiny.copy_checkout(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "wmbench.run", "--workload", tiny.CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout == ""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "wmbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_throwaway_cell_needs_only_new_files(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric, each a
    new file, and new entries in BENCHMARK.json: the copied harness runs
    the new cell unedited."""
    root = tiny.copy_checkout(tmp_path)
    before = _digests(root)
    wm = root / "wmbench"
    cfg = json.loads((wm / "configs" / "worldmirror_large.json").read_text())
    tiny.write_json(wm / "configs" / "throwaway_tiny.json",
                    {**cfg, **tiny.TINY, "name": "throwaway_tiny"})
    traffic = json.loads((wm / "traffic" / "recon_s4_ring.json").read_text())
    tiny.write_json(wm / "traffic" / "throwaway_mix.json", {**traffic, **tiny.TINY_TRAFFIC})
    tiny.write_json(wm / "limits" / "throwaway.cell.json",
                    json.loads((wm / "limits" / f"{tiny.CELL}.json").read_text()))
    (wm / "metrics" / "throwaway_requests.py").write_text(
        'LAYER = "entry: infer.reconstruct"\nUNIT = "requests"\nSOURCE = "host_clock"\n'
        'MOVES = "frames_per_s"\nWORKLOADS = ["throwaway.cell"]\n\n\n'
        'def read(run):\n    return len(run.latencies)\n')
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "throwaway_tiny", "source": "https://arxiv.org/abs/2510.10726",
                           "file": "wmbench/configs/throwaway_tiny.json", "reduced": [],
                           "why": "test"})
    man["workloads"].append({"name": "throwaway.cell", "config": "throwaway_tiny",
                             "traffic": "throwaway_mix", "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if "workloads" in m and "frames_per_s" == m["name"]:
            m["workloads"].append("throwaway.cell")
    man["per_layer"].append({"name": "throwaway_requests", "unit": "requests",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry: infer.reconstruct", "moves": "frames_per_s",
                             "workloads": ["throwaway.cell"]})
    tiny.write_json(root / "BENCHMARK.json", man)
    code = ("import json\nfrom wmbench import run\n"
            "parts = run.cell_parts(run.manifest(), 'throwaway.cell')\n"
            "assert str(run.HERE).startswith(%r)\n"
            "res = run.run_cell(parts, 11, 0.5, True, 'cpu', log=lambda *_: None)\n"
            "print(json.dumps(res))\n" % str(root))
    env = {**os.environ, "PYTHONPATH": str(tiny.REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["throwaway_requests"]["value"] >= 1
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
