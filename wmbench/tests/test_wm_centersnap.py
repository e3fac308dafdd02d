"""The 6D-pose training cell at a tiny size on the CPU: its manifest
entries resolve to their files, the reference imports nothing of the
program, the unbroken program is correct, a planted fault is not (an
altered head, an altered loss, a frozen backbone leaf moved during the
window, AdamW without its decay or with another beta2), the control is not, and a program that trains the backbone is
refused at set-up."""

import importlib
import json
import math

import pytest
import torch

from wmbench import run
from wmbench.systems import centersnap_train as cst
from wmbench.tests import centersnap_tiny as ct
from wmbench.tests.test_wm_isolation import FORBIDDEN, PROGRAM, _imports
from wmbench.tests.tiny import REPO

SEED = 2 ** 31 + 23


def _run(monkeypatch, seconds=0.5):
    ct.patch_program(monkeypatch)
    return run.run_cell(ct.parts(), SEED, seconds, False, "cpu", log=lambda *_: None)


def test_reference_imports_nothing_of_the_program():
    names = set(_imports(REPO / "wmbench" / "reference" / "centersnap.py"))
    assert PROGRAM not in names and not names & FORBIDDEN
    for sub in ("frozen/centersnap_arith.py", "traffic/sope.py"):
        assert not set(_imports(REPO / "wmbench" / sub)) & (FORBIDDEN | {PROGRAM})


def test_manifest_entries_resolve():
    man = run.manifest(REPO)
    parts = run.cell_parts(man, ct.CELL, REPO / "wmbench")
    conf = {c["name"]: c for c in man["configs"]}["centersnap_sope"]
    assert parts.cfg == json.loads((REPO / conf["file"]).read_text())
    assert parts.cfg["reduced"] == conf["reduced"] == [] and parts.cfg["name"] == conf["name"]
    assert parts.traffic["kind"] == "sope" and parts.traffic["batch"] == parts.cfg["batch_size"]
    assert {m["name"] for m in parts.end_to_end} == {"train_steps_per_s", "peak_gb", "setup_s"}
    names = {m["name"] for m in parts.per_layer}
    assert names == {f"{n}.centersnap" for n in (
        "encoder_ms", "trunk_ms", "heads_ms", "loss_ms", "backward_ms", "optimizer_ms",
        "host_syncs", "launches", "idle_share", "mfu")}
    assert set(parts.limits) == {"trunk_gap", "heads_gap", "loss_gap", "heads_grad_gap",
                                 "grad_gap", "change_gap", "frozen_moved", "adamw_gap"}
    importlib.import_module(f"wmbench.systems.{parts.cfg['system']}")
    importlib.import_module(f"wmbench.traffic.{parts.traffic['kind']}")


def test_published_flags_are_the_cli_defaults():
    """The configuration the cell passes as flags is the one the CLI builds
    from `--backbone dinov3_vits16 --depth-cond` alone."""
    from hunyuanworld_mirror_tpu_torch import train as cli
    parts = run.cell_parts(run.manifest(REPO), ct.CELL, REPO / "wmbench")
    ours = cst.port_config(parts.cfg, parts.traffic["batch"])
    published = cli.config(cli.parser().parse_args(
        ["--train-shards", "", "--backbone", "dinov3_vits16", "--depth-cond"]))
    assert ours == published


def test_unbroken_program_is_correct(monkeypatch):
    res = _run(monkeypatch)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["frozen_moved"]["value"] == 0
    for k in ("heads_gap", "loss_gap", "heads_grad_gap"):   # f32 on both sides
        assert res["checks"][k]["value"] <= 1e-6, k
    assert res["checks"]["adamw_gap"]["value"] <= 2e-7   # a few roundings of each leaf


def _altered_head(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.models.centersnap import CenterSnap
    real = CenterSnap.forward

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        return {**out, "pose_map": out["pose_map"] * 1.001}

    monkeypatch.setattr(CenterSnap, "forward", altered)


def _moved_frozen_leaf(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.training import trainer
    real = trainer.AdamWCosine.step

    def step(self):
        real(self)
        frozen = next(p for p in self.params if not p.requires_grad)
        with torch.no_grad():
            frozen.add_(1e-6)

    monkeypatch.setattr(trainer.AdamWCosine, "step", step)


def _optimizer_set(**group):
    """A plant that builds the program's AdamW with `group`'s settings in
    place of the configuration's."""
    def plant(monkeypatch):
        from hunyuanworld_mirror_tpu_torch.training import trainer
        real = trainer.AdamWCosine.__init__

        def init(self, *a, **k):
            real(self, *a, **k)
            self.opt.param_groups[0].update(group)

        monkeypatch.setattr(trainer.AdamWCosine, "__init__", init)
    return plant


def _altered_loss(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.training import losses
    real = losses.centersnap_loss

    def altered(preds, batch, heat_weight=100.0, **k):
        return real(preds, batch, heat_weight=heat_weight * 1.001, **k)

    monkeypatch.setattr(losses, "centersnap_loss", altered)


@pytest.mark.parametrize("plant,number", [(_altered_head, "heads_gap"),
                                          (_altered_loss, "loss_gap"),
                                          (_moved_frozen_leaf, "frozen_moved"),
                                          (_optimizer_set(weight_decay=0.0), "adamw_gap"),
                                          (_optimizer_set(betas=(0.9, 0.99)), "adamw_gap")],
                         ids=["head", "loss", "frozen", "no_decay", "beta2"])
def test_a_broken_step_is_not_correct(monkeypatch, plant, number):
    plant(monkeypatch)
    res = _run(monkeypatch)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct_tiny(seed):
    p = ct.parts()
    nums = cst.control_numbers(p.cfg, p.traffic, seed, "cpu",
                               importlib.import_module("wmbench.traffic.sope"))
    assert any(not math.isfinite(v) or v > p.limits[k] for k, v in nums.items())
    assert nums["heads_gap"] > p.limits["heads_gap"]


def test_a_program_that_trains_the_backbone_is_refused(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.models.centersnap import CenterSnap
    monkeypatch.setattr(CenterSnap, "backbone_frozen", property(lambda self: False))
    with pytest.raises(RuntimeError, match="freeze"):
        _run(monkeypatch)
