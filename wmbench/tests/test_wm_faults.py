"""The harness with the timed path broken underneath sees `correct` come
out false. Reconstruction: an answer altered where it is produced, half of
the views left out of the trunk, a stale render. Refinement: a step that
leaves its state unchanged, half of the cameras left out of the loss (its
mean over the rest), the render altered where it is produced. No cell has
an exchange between chips. The look for a card is skipped: the tiny cells
run on the CPU."""

import pytest
import torch

from wmbench import run
from wmbench.tests import tiny


def _altered_heads(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.models import dpt
    real = dpt.activate_head

    def altered(out, activation="inv_log+expp1"):
        attr, conf = real(out, activation)
        return attr * 1.001, conf

    monkeypatch.setattr(dpt, "activate_head", altered)


def _half_the_views(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.models.aggregator import VisualGeometryTransformer
    real = VisualGeometryTransformer.forward

    def half(self, images, *a, **k):
        S = images.shape[1]
        toks, start = real(self, images[:, :S // 2], *a, **k)
        return [torch.cat([t, t], 1) for t in toks], start

    monkeypatch.setattr(VisualGeometryTransformer, "forward", half)


def _stale_render(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.models import gaussians
    real = gaussians.render
    first = {}

    def stale(*a, **k):
        preds = real(*a, **k)
        keys = ("rendered_colors", "rendered_depths", "rendered_alphas")
        if not first:
            first.update({key: preds[key].clone() for key in keys})
        preds.update(first)
        return preds

    monkeypatch.setattr(gaussians, "render", stale)


@pytest.mark.parametrize("plant", [_altered_heads, _half_the_views, _stale_render])
def test_a_broken_program_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    res = run.run_cell(tiny.parts(), 2 ** 31 + 7, 0.5, False, "cpu", log=lambda *_: None)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_the_unbroken_program_is_correct():
    res = run.run_cell(tiny.parts(), 2 ** 31 + 7, 0.5, False, "cpu", log=lambda *_: None)
    assert res["correct"] is True


def _state_unchanged(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    real = splat_opt.make_optimizer

    def frozen(*a, **k):
        opt = real(*a, **k)
        opt.step = lambda *_a, **_k: None
        return opt

    monkeypatch.setattr(splat_opt, "make_optimizer", frozen)


def _half_the_cameras(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.training import losses
    real = losses.photometric_loss

    def half(pred, target, lam=0.2):
        n = pred.shape[0] // 2
        return real(pred[:n], target[:n], lam)

    monkeypatch.setattr(losses, "photometric_loss", half)


def _altered_render(monkeypatch):
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    real = splat_opt.render_splats

    def altered(*a, **k):
        colors, alphas, meta = real(*a, **k)
        return colors * 1.01, alphas, meta

    monkeypatch.setattr(splat_opt, "render_splats", altered)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_the_cameras, _altered_render])
def test_a_broken_refine_step_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    res = run.run_cell(tiny.refine_parts(), 2 ** 31 + 9, 0.3, False, "cpu",
                       log=lambda *_: None)
    assert res["correct"] is False


def test_the_unbroken_refine_step_is_correct():
    res = run.run_cell(tiny.refine_parts(), 2 ** 31 + 9, 0.3, False, "cpu",
                       log=lambda *_: None)
    assert res["correct"] is True
