"""`chip_smoke.py` of two checkouts in turns (parent, change, change,
parent), one NVIDIA GPU, and each run's end-to-end medians and kernel
times side by side.

    python3 tools/smoke_ab.py PARENT [TREE]

PARENT and TREE (default: this checkout) are checkout roots, the parent
unpacked with `git archive` into a directory `.gitignore` lists (e.g.
build/ab/parent). Each run is that tree's own `python3 chip_smoke.py`,
started in its root (so it builds that tree's kernels), its whole output
kept in build/smoke_ab/<run>.log. Then, per run: its exit code, the median
of its 7 timed forwards (phase 5), its training step's medians (phase 8:
render forward, backward, optimizer, total) and each kernel's `ms` from its
`kernels` line; and one JSON line with all of it. It exits non-zero when a
run failed. Nothing here runs without a card.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "smoke_ab"
FORWARD = re.compile(r"main path forward total: median ([\d.]+) ms")
STEP = re.compile(r"training step \(median of \d+ steps without a refine\): "
                  r"render_forward ([\d.]+) ms  backward ([\d.]+) ms  optimizer "
                  r"([\d.]+) ms  total ([\d.]+) ms")


def summarise(log: str) -> dict:
    """One chip_smoke.py log -> its forward median, step medians and kernel
    times (None where the run did not get that far)."""
    fwd, step = FORWARD.search(log), STEP.search(log)
    kernels = {}
    for line in log.splitlines():
        if line.startswith('{"kernels"'):
            kernels = {k["name"]: k["ms"] for k in json.loads(line)["kernels"]}
    return dict(
        forward_ms=float(fwd.group(1)) if fwd else None,
        step_ms=(dict(zip(("render_forward", "backward", "optimizer", "total"),
                          map(float, step.groups()))) if step else None),
        kernels_ms=kernels)


def main() -> int:
    if not sys.argv[1:] or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    tree = Path(sys.argv[2]).resolve() if sys.argv[2:] else ROOT
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    runs = {}
    for name, root in (("P1", parent), ("C1", tree), ("C2", tree), ("P2", parent)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                              capture_output=True, text=True, timeout=1200)
        log = proc.stdout + proc.stderr
        (OUT_DIR / f"{name}.log").write_text(log)
        runs[name] = dict(rc=proc.returncode, **summarise(log))
        r = runs[name]
        print(f"{name} ({root}): rc {r['rc']}  forward median {r['forward_ms']} ms  "
              f"step {r['step_ms']}", flush=True)
    names = sorted({k for r in runs.values() for k in r["kernels_ms"]})
    for k in names:
        print(f"  {k:55s} " + "  ".join(
            f"{n} {runs[n]['kernels_ms'].get(k, float('nan')):.4f}" for n in runs))
    print(json.dumps(dict(parent=str(parent), tree=str(tree), runs=runs)), flush=True)
    return 0 if all(r["rc"] == 0 for r in runs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
