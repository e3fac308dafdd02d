"""The port's CenterSnap training step against the benchmark's plain
reference (wmbench/reference/centersnap.py: f32, no module of the port),
on weights the reference draws from a seed and the port loads by name.

The size is small: a 2-layer DINOv3-style backbone 64 wide with 2 heads
(the port's dinov3_vits16 factory patched to it), a trunk 64 wide with 2
heads and 2 layers, heads of 16 features, 64 px, B=2, the depth condition
on; the batch is the benchmark's own SOPE traffic at that size. Bands:
  * the port with its trunk in f32 (the aggregator's dtype argument)
    against the reference: the intermediates within 2e-5 of their norm, the
    heatmap and pose map within 1e-5 of their largest value, the loss
    within 1e-6 relative, each trainable leaf's gradient within 1e-4 of the
    larger of its own norm and the median leaf's (f32 in both, the sums
    in another order; the floor keeps a leaf whose gradient nearly cancels
    from reading its rounding as a fault);
  * the shipped route (bf16 trunk): the reference's f32 heads on the port's
    own bf16 intermediates within 1e-5 (the heads are f32 on both sides),
    the loss within 5e-3 relative of the reference's f32 one (the trunk's
    bf16 rounding);
  * AdamWCosine against the reference's AdamW on the same gradients: every
    leaf within 1e-7 after one update (lr 5e-5: the step itself is 5e-5);
  * the frozen backbone takes no gradient, no optimizer state, no decay,
    and stays bit for bit what was loaded, through a step, a checkpoint and
    a resume.
The CLI's --backbone: the published flags build the published
configuration; the default builds the JAX CLI's; the published flags
train, checkpoint and resume on the CPU (at 32 px, B=2).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from hunyuanworld_mirror_tpu.models import centersnap as jcs
from hunyuanworld_mirror_tpu_torch import convert
from hunyuanworld_mirror_tpu_torch import train as ptrain
from hunyuanworld_mirror_tpu_torch import wds_tools as pwds
from hunyuanworld_mirror_tpu_torch.models import centersnap as pcs
from hunyuanworld_mirror_tpu_torch.models import dinov2 as pdino
from hunyuanworld_mirror_tpu_torch.training import checkpoint as pckpt
from hunyuanworld_mirror_tpu_torch.training import losses as plosses
from hunyuanworld_mirror_tpu_torch.training import trainer as ptrainer
from wmbench.reference import centersnap as ref
from wmbench.traffic import sope

REPO = Path(__file__).resolve().parents[1]
FILE = json.loads((REPO / "wmbench" / "configs" / "centersnap_sope.json").read_text())
CFG = {**FILE, "img_size": 64, "embed_dim": 64, "trunk_depth": 2, "trunk_heads": 2,
       "head_features": 16, "intermediate_idxs": [0, 0, 1, 1], "encoder_dim": 64,
       "encoder_depth": 2, "encoder_heads": 2}
TRAFFIC = {"batch": 2, "size": 64, "pool": 2, "objects": [1, 6], "sigma_px": [2.0, 8.0],
           "depth_m": [0.1, 25.0]}


@pytest.fixture
def tiny_backbone(monkeypatch):
    monkeypatch.setitem(pdino.VIT_FACTORIES, "dinov3_vits16", dataclasses.replace(
        pdino.VIT_FACTORIES["dinov3_vits16"], embed_dim=CFG["encoder_dim"],
        depth=CFG["encoder_depth"], num_heads=CFG["encoder_heads"]))


def _train_config():
    return ptrainer.TrainConfig(model=pcs.CenterSnapConfig(
        img_size=CFG["img_size"], patch_size=CFG["patch_size"], embed_dim=CFG["embed_dim"],
        trunk_depth=CFG["trunk_depth"], trunk_heads=CFG["trunk_heads"],
        patch_embed=CFG["encoder"], use_depth_condition=True,
        heatmap_features=CFG["head_features"]))


def _setup(seed):
    """(train config, the port's model with the reference's weights, those
    weights, the host batches)."""
    tc = _train_config()
    model = ptrainer.model_init(tc, "cpu")
    sd = ref.make_weights(CFG, seed, "cpu")
    model.load_state_dict(sd, strict=True)
    return tc, model, sd, sope.make(TRAFFIC, seed)["batches"]


def _port_f32(model, b):
    """CenterSnap.forward with the trunk in f32: (intermediates, preds)."""
    imgs = b["rgb"][:, None]
    toks, start = model.encoder(imgs, priors=(b["depth"][:, None], None, None),
                                cond_flags=(0, 1, 0), dtype=torch.float32)
    heat, _ = model.heatmap_head(toks, imgs, start)
    pose, _ = model.pose_head(toks, imgs, start)
    return toks, {"heatmap": heat[:, 0], "pose_map": pose[:, 0]}


def _rel(a, r):
    a, r = a.detach().float(), r.detach().float()
    return float(torch.linalg.norm(a - r) / torch.linalg.norm(r))


def _rel_max(a, r):
    a, r = a.detach().float(), r.detach().float()
    return float((a - r).abs().max() / r.abs().max())


def test_reference_names_every_port_leaf_and_freezes_the_backbone(tiny_backbone):
    tc, model, sd, _ = _setup(3)
    params = dict(model.named_parameters())
    assert set(sd) == set(model.state_dict()) == set(params)
    assert all(tuple(sd[n].shape) == tuple(p.shape) for n, p in params.items())
    assert {n for n, p in params.items() if not p.requires_grad} == {n for n in sd
                                                                     if ref.frozen(n)}
    assert model.backbone_frozen and any(ref.frozen(n) for n in sd)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_f32_route_matches_the_reference(tiny_backbone, seed):
    tc, model, sd, batches = _setup(seed)
    b = ptrainer._prepare_batch(tc, batches[0], "cpu")
    toks, preds = _port_f32(model, b)
    loss, _ = plosses.centersnap_loss(preds, b)
    loss.backward()

    params = {k: v.clone().requires_grad_(not ref.frozen(k)) for k, v in sd.items()}
    rb = ref.prepare(batches[0], "cpu")
    r_toks = ref.trunk(params, CFG, rb["rgb"], rb["depth"])
    r_preds = ref.heads(params, CFG, r_toks, 64, 64)
    r_loss = ref.loss(r_preds, rb)
    r_loss.backward()

    assert max(_rel(a, r) for a, r in zip(toks, r_toks)) <= 2e-5
    for k in ("heatmap", "pose_map"):
        assert preds[k].shape == r_preds[k].shape
        assert _rel_max(preds[k], r_preds[k]) <= 1e-5, k
    assert abs(float(loss) - float(r_loss)) <= 1e-6 * abs(float(r_loss))
    ports = dict(model.named_parameters())
    norms = {k: float(torch.linalg.norm(p.grad)) for k, p in params.items()
             if p.grad is not None}
    med = float(np.median(list(norms.values())))
    assert set(norms) == {k for k, p in ports.items() if p.grad is not None}
    for k, n in norms.items():
        gap = float(torch.linalg.norm(ports[k].grad - params[k].grad))
        assert gap <= 1e-4 * max(n, med), (k, gap, n)
    assert all(ports[k].grad is None for k in sd if ref.frozen(k))


def test_shipped_route_heads_and_loss(tiny_backbone):
    tc, model, sd, batches = _setup(7)
    b = ptrainer._prepare_batch(tc, batches[0], "cpu")
    kept = {}
    model.encoder.register_forward_hook(lambda _m, _i, out: kept.update(toks=out[0]) and None)
    with torch.no_grad():
        preds = model(b["rgb"], b["depth"])
        loss, _ = plosses.centersnap_loss(preds, b)
        assert all(t.dtype == torch.bfloat16 for t in kept["toks"])
        r_heads = ref.heads(sd, CFG, kept["toks"], 64, 64)
        rb = ref.prepare(batches[0], "cpu")
        r_loss = ref.loss(ref.heads(sd, CFG, ref.trunk(sd, CFG, rb["rgb"], rb["depth"]),
                                    64, 64), rb)
    for k in ("heatmap", "pose_map"):
        assert _rel_max(preds[k], r_heads[k]) <= 1e-5, k
    assert abs(float(loss) - float(r_loss)) <= 5e-3 * abs(float(r_loss))


def test_adamw_cosine_step_matches_the_reference(tiny_backbone):
    tc, model, sd, _ = _setup(9)
    opt = ptrainer.make_optimizer(tc, model)
    gen = torch.Generator().manual_seed(1)
    ports = dict(model.named_parameters())
    grads = {k: (None if "pose_embed" in k else torch.randn(p.shape, generator=gen))
             for k, p in ports.items() if p.requires_grad}
    for k, g in grads.items():
        ports[k].grad = None if g is None else g.clone()
    opt.step()
    params = {k: sd[k].clone() for k in grads}
    ref.adamw(params, grads, {}, ref.learning_rate(FILE, 0), FILE["weight_decay"], 1)
    for k, p in params.items():
        assert float((ports[k].detach() - p).abs().max()) <= 1e-7, k
    assert all(torch.equal(ports[k], sd[k]) for k in sd if ref.frozen(k))


def test_frozen_backbone_takes_no_gradient_state_or_decay(tiny_backbone):
    """One shipped step: the backbone gets no gradient, the optimizer holds
    nothing for it and its moments export as zeros; it stays bit for bit
    what was loaded while every trainable leaf moves (a leaf the loss
    misses by its decay alone, but for the zero biases of the pose and ray
    tokens' embedders, which nothing moves)."""
    tc, model, sd, batches = _setup(13)
    opt = ptrainer.make_optimizer(tc, model)
    step = ptrainer.make_train_step(tc, model, opt)
    ptrainer.train_iteration(tc, step, batches[0], "cpu")
    ports = dict(model.named_parameters())
    frozen = [k for k in sd if ref.frozen(k)]
    assert all(ports[k].grad is None and ports[k] not in opt.opt.state for k in frozen)
    assert all(torch.equal(ports[k], sd[k]) for k in frozen)
    still = [k for k, p in ports.items() if p.requires_grad and torch.equal(p, sd[k])]
    assert len(opt.trainable) == len(ports) - len(frozen)
    assert still and all(not sd[k].any() and not ports[k].grad.any() for k in still)
    _, _, mu, nu = opt.export_state()
    assert all(not mu[k].any() and not nu[k].any() for k in frozen if k in mu)   # JAX's leaves
    assert all(nu[k].any() for k, p in ports.items() if p.requires_grad
               and "pose_embed" not in k and "ray_embed" not in k)


def test_adamw_cosine_leaves_a_frozen_leaf_and_its_decay_alone():
    """A frozen leaf with a stale gradient neither steps nor decays; a
    trainable leaf the loss misses decays (optax's zero-gradient step)."""
    model = pcs.CenterSnap(pcs.CenterSnapConfig(img_size=32, embed_dim=32, trunk_depth=1,
                                                trunk_heads=2, heatmap_features=16))
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(0.5)
    frozen = model.heatmap_head.norm.weight
    frozen.requires_grad_(False)
    frozen.grad = torch.ones_like(frozen)
    missed = model.pose_head.norm.weight
    opt = ptrainer.AdamWCosine(model, 1e-2, None, 0.1)
    opt.step()
    assert torch.equal(frozen, torch.full_like(frozen, 0.5))
    assert torch.allclose(missed, torch.full_like(missed, 0.5 * (1 - 1e-2 * 0.1)))
    assert frozen not in opt.opt.state and len(opt.params) == len(opt.leaves)


def test_checkpoint_with_a_frozen_backbone_resumes(tiny_backbone, tmp_path):
    """Two steps straight on, against one step, a checkpoint (the JAX
    layout, the backbone's moments zero), a fresh model resumed from it,
    and the second step: the same parameters, the backbone the loaded
    one."""
    tc, model, sd, batches = _setup(17)
    opt = ptrainer.make_optimizer(tc, model)
    step = ptrainer.make_train_step(tc, model, opt)
    ptrainer.train_iteration(tc, step, batches[0], "cpu")
    path = pckpt.save_params(str(tmp_path / "cs.npz"), model, step=1, optimizer=opt)
    ptrainer.train_iteration(tc, step, batches[1], "cpu")

    resumed = ptrainer.model_init(dataclasses.replace(tc, seed=99), "cpu")
    tree, saved = pckpt.load_train_state(path)
    convert.load_jax_tree(resumed, tree)
    r_opt = ptrainer.make_optimizer(tc, resumed)
    assert pckpt.restore_opt_state(path, resumed, r_opt) and saved == 1
    r_step = ptrainer.make_train_step(tc, resumed, r_opt)
    ptrainer.train_iteration(tc, r_step, batches[1], "cpu")
    assert r_opt.count == opt.count == 2
    theirs = dict(resumed.named_parameters())
    for k, p in model.named_parameters():
        assert float((theirs[k] - p).abs().max()) <= 1e-7, k
    assert all(torch.equal(theirs[k], sd[k]) for k in sd if ref.frozen(k))


PUBLISHED = ["--backbone", "dinov3_vits16", "--depth-cond"]


def test_backbone_flag_builds_the_published_and_the_default_configs():
    base = ["--train-shards", "s-{000..003}.tar"]
    pub = ptrain.config(ptrain.parser().parse_args(base + PUBLISHED))
    assert pub.model == pcs.CenterSnapConfig(
        img_size=384, patch_size=16, embed_dim=384, trunk_depth=4, trunk_heads=6,
        patch_embed="dinov3_vits16", use_depth_condition=True, heatmap_features=128,
        pose_down_ratio=2)
    assert (pub.batch_size, pub.lr, pub.weight_decay, pub.epochs * pub.steps_per_epoch) == (
        FILE["batch_size"], FILE["lr"], FILE["weight_decay"], FILE["schedule_steps"])
    vit = pub.model.vgt.vit_config
    assert (vit.embed_dim, vit.depth, vit.num_heads, vit.patch_size, vit.use_rope) == (
        384, 12, 6, 16, True)
    assert pcs.CenterSnap(pub.model).backbone_frozen
    default = ptrain.config(ptrain.parser().parse_args(base))
    assert default.model.patch_embed == "conv"
    assert dataclasses.asdict(default.model) == dataclasses.asdict(
        jcs.CenterSnapConfig(img_size=384, patch_size=16, use_depth_condition=False))
    with pytest.raises(SystemExit):
        ptrain.parser().parse_args(base + ["--backbone", "dinov2_vitl14_reg"])


def test_cli_trains_the_published_configuration_and_resumes(tmp_path):
    """The published flags at 32 px and B=2: 2 steps and a checkpoint, then
    --resume for 2 more; the backbone (ViT-S/16 at its widths) is the
    seeded init's, bit for bit, in both checkpoints."""
    src = chip_smoke.write_sope_samples(tmp_path / "samples", 4, 32, 3)
    pwds.main(["convert", str(src), str(tmp_path / "shards"), "--shard-size", "2",
               "--prefix", "train", "--gen-targets"])
    ckpt = str(tmp_path / "cs.npz")
    base = ["--train-shards", str(tmp_path / "shards" / "train-*.tar"), "--batch-size", "2",
            "--img-size", "32", "--epochs", "1", "--ckpt", ckpt] + PUBLISHED
    init = ptrainer.model_init(ptrain.config(ptrain.parser().parse_args(base)), "cpu")
    backbone = {k: p.detach().clone() for k, p in init.named_parameters()
                if k.startswith("encoder.patch_embed.")}
    for extra, want in (([], [1, 2]), (["--resume", ckpt], [3, 4])):
        steps = []
        model = ptrain.main(base + extra, device="cpu", log_fn=lambda *_: None,
                            on_step=lambda s, loss, logs, marks: steps.append((s, float(loss))))
        assert [s for s, _ in steps] == want and all(np.isfinite(v) for _, v in steps)
        params = dict(model.named_parameters())
        assert all(torch.equal(params[k], v) and not params[k].requires_grad
                   for k, v in backbone.items())
        saved = dict(model.named_parameters())
        reloaded = ptrainer.model_init(ptrain.config(ptrain.parser().parse_args(base)), "cpu")
        convert.load_jax_tree(reloaded, pckpt.load_params(ckpt))
        assert all(torch.equal(p, saved[k]) for k, p in reloaded.named_parameters())
