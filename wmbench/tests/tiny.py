"""A tiny WorldMirror cell for the CPU tests: the recon cell's files with
the widths cut to what a test run holds (the cell itself runs at the
published widths on the card)."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

from wmbench import run

REPO = Path(__file__).resolve().parents[2]

TINY = dict(encoder="conv", embed_dim=64, encoder_dim=64, trunk_depth=4, trunk_heads=4,
            intermediate_idxs=[0, 1, 2, 3], dpt_features=32,
            dpt_out_channels=[16, 32, 64, 64], gs_dim=32, img_size=56)
TINY_TRAFFIC = dict(views=2, size=56, pool=3, warmup=1, trace_requests=1)
CELL = "recon.large.s4"


def parts(**cfg_changes) -> SimpleNamespace:
    """The recon cell's parts with the tiny widths."""
    p = run.cell_parts(run.manifest(REPO), CELL)
    return SimpleNamespace(**{**vars(p), "cfg": {**p.cfg, **TINY, **cfg_changes},
                              "traffic": {**p.traffic, **TINY_TRAFFIC}})


def copy_checkout(dest: Path) -> Path:
    """BENCHMARK.json and wmbench/ (no caches) copied into `dest`."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "wmbench", dest / "wmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    return dest


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))

REFINE = "refine.gsplat.s4"


def refine_parts() -> SimpleNamespace:
    """The refine cell's parts on the tiny reconstruction's export."""
    p = run.cell_parts(run.manifest(REPO), REFINE)
    return SimpleNamespace(**{**vars(p), "cfg": {**p.cfg, "scene_from": parts().cfg},
                              "traffic": {**p.traffic, "views": 2, "size": 56,
                                          "trace_requests": 2}})
