"""The plain reference against the program at a tiny size on the CPU (this
test imports both; the reference itself imports nothing of the program)."""

import numpy as np
import pytest
import torch

from wmbench.systems import worldmirror as wmb
from wmbench.reference import model as ref_model
from wmbench.reference import render as ref_render
from wmbench.reference.precision import CONTROL, REFERENCE
from wmbench.reference.weights import make_weights, param_spec
from wmbench.tests import tiny
from wmbench.traffic import scenes


def _setup(seed=3, **changes):
    from hunyuanworld_mirror_tpu_torch import infer
    p = tiny.parts(**changes)
    model = infer.load_model(wmb.port_config(p.cfg), device="cpu")
    w = make_weights(p.cfg, seed, "cpu")
    model.load_state_dict(w, strict=True)
    data = scenes.make(p.traffic, seed)
    sd = {k: v.float() for k, v in w.items()}
    return p, model, sd, torch.as_tensor(data["scenes"][0]), torch.as_tensor(data["cameras"])


def test_spec_names_are_the_programs():
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirror
    p = tiny.parts()
    mine = {n: tuple(s) for n, s, _ in param_spec(p.cfg)}
    theirs = {n: tuple(t.shape) for n, t in
              WorldMirror(wmb.port_config(p.cfg), device="cpu").state_dict().items()}
    assert mine == theirs


def test_weights_follow_the_seed():
    p = tiny.parts()
    a, b = make_weights(p.cfg, 5, "cpu"), make_weights(p.cfg, 5, "cpu")
    c = make_weights(p.cfg, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cam_head.param_embed.weight"], c["cam_head.param_embed.weight"])
    assert float(a["visual_geometry_transformer.frame_blocks.0.attn.qkv.weight"].float().abs().max()) <= 0.0401
    assert float(a["gs_renderer.gs_head.2.bias"][4]) == -7.0


def test_trunk_in_f32_matches_the_programs():
    p, model, sd, img, _ = _setup()
    with torch.no_grad():
        mine = ref_model.trunk(sd, p.cfg, img)
        theirs, start = model.visual_geometry_transformer(img, dtype=torch.float32)
    assert start == ref_model.n_special(p.cfg)
    for a, r in zip(theirs, mine):
        assert float((a - r).abs().max() / r.abs().max()) < 1e-5


def test_heads_and_render_match_the_programs():
    from hunyuanworld_mirror_tpu_torch import infer
    p, model, sd, img, cams = _setup()
    toks = []
    model.visual_geometry_transformer.register_forward_hook(lambda m, i, o: toks.append(o[0]))
    out = infer.reconstruct(model, img.numpy(), camera_params=cams.numpy())
    nums = wmb.compare(sd, p.cfg, img, cams, out, toks[0])
    assert nums["heads_gap"] < 1e-5
    assert nums["render_gap"] < 1e-3 and nums["splat_gap"] < 1e-5
    assert nums["trunk_gap"] < 0.02


def test_reference_in_the_programs_place_reads_zero():
    p, _, sd, img, cams = _setup()
    out, toks = wmb.control_outputs(sd, p.cfg, img, cams, REFERENCE)
    assert wmb.compare(sd, p.cfg, img, cams, out, toks) == {
        "trunk_gap": 0.0, "heads_gap": 0.0, "render_gap": 0.0, "splat_gap": 0.0}


def test_render_counts_what_it_blends():
    p, _, sd, img, cams = _setup()
    with torch.no_grad():
        out = ref_model.heads(sd, p.cfg, ref_model.trunk(sd, p.cfg, img), img)
        s = ref_render.splats(sd, p.cfg, out["gs_feat"], out["gs_depth"], img, cams)
        col, dep, alpha, n = ref_render.render(s, cams[0], 56, 56, p.cfg["render"])
    assert n == [c for c, _ in ref_render.count_isects(s, cams[0], 56, 56, p.cfg["render"])]
    assert col.shape == (2, 56, 56, 3) and float(alpha.max()) <= 1.0
    assert np.isfinite(dep.numpy()).all()


def _whole_attention(q, k, v, rnd, heads_at_once=4):
    """The whole score matrix of each group of heads at once."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for h in range(0, q.shape[2], heads_at_once):
        qh, kh, vh = (t[:, :, h:h + heads_at_once].transpose(1, 2) for t in (q, k, v))
        p = torch.softmax(torch.matmul(rnd(qh), rnd(kh).transpose(-1, -2)) * scale, -1)
        outs.append(torch.matmul(rnd(p), rnd(vh)))
    return torch.cat(outs, dim=1).transpose(1, 2)


@pytest.mark.parametrize("prec", [REFERENCE, CONTROL], ids=["reference", "control"])
@pytest.mark.parametrize("B", [1, 2])
def test_blocked_attention_equals_the_whole_matrix(B, prec):
    """Query blocks of 5 rows over N = 23 (a ragged last block of 3), 8
    heads in groups of 4: the same as the whole score matrix, the control's
    fp8 included (one scale a group of heads, from every block)."""
    g = torch.Generator().manual_seed(B)
    N, H, D = 23, 8, 16
    q, k, v = (torch.randn(B, N, H, D, generator=g) * 2 for _ in range(3))
    whole = _whole_attention(q, k, v, prec.trunk)
    assert torch.equal(ref_model.attention(q, k, v, prec.trunk), whole)
    blocked = ref_model.attention(q, k, v, prec.trunk, block_bytes=4 * B * 4 * N * 5)
    assert float((blocked - whole).abs().max() / whole.abs().max()) < 1e-6
