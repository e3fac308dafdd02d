"""A tiny CenterSnap training cell for the CPU tests: the cell's files
with the widths cut to what a test run holds (the cell itself runs at the
published widths on the card). The program's DINOv3 factory and
CenterSnapConfig's widths are patched to the same tiny sizes, since the
CLI names the backbone by its factory."""

import dataclasses
import functools
from types import SimpleNamespace

from wmbench import run
from wmbench.tests.tiny import REPO

CELL = "train.centersnap.b20"
TINY = dict(img_size=64, embed_dim=64, trunk_depth=2, trunk_heads=2, head_features=16,
            intermediate_idxs=[0, 0, 1, 1], encoder_dim=64, encoder_depth=2, encoder_heads=2,
            batch_size=2)
TINY_TRAFFIC = dict(batch=2, size=64, pool=3, warmup=1, trace_requests=1, sigma_px=[2.0, 8.0])


def parts(**cfg_changes) -> SimpleNamespace:
    """The cell's parts with the tiny widths."""
    p = run.cell_parts(run.manifest(REPO), CELL)
    return SimpleNamespace(**{**vars(p), "cfg": {**p.cfg, **TINY, **cfg_changes},
                              "traffic": {**p.traffic, **TINY_TRAFFIC}})


def patch_program(monkeypatch) -> None:
    """The program's dinov3_vits16 and CenterSnapConfig at the tiny widths."""
    from hunyuanworld_mirror_tpu_torch.models import centersnap, dinov2
    t = TINY
    monkeypatch.setitem(dinov2.VIT_FACTORIES, "dinov3_vits16", dataclasses.replace(
        dinov2.VIT_FACTORIES["dinov3_vits16"], embed_dim=t["encoder_dim"],
        depth=t["encoder_depth"], num_heads=t["encoder_heads"]))
    monkeypatch.setattr(centersnap, "CenterSnapConfig", functools.partial(
        centersnap.CenterSnapConfig, embed_dim=t["embed_dim"], trunk_depth=t["trunk_depth"],
        trunk_heads=t["trunk_heads"], heatmap_features=t["head_features"]))
