"""The 6D-pose models of the port against the JAX package, on seeded inputs.

Port modules are built with their own init; their state dicts go through
tools/convert_weights (and convert.to_jax_tree, which must agree with it)
into the JAX functions. Bands:
  * the frame-only trunk, the conv and conv-mlp patch embeds, the giant2
    and DINOv3 encoders: f32, atol 2e-4;
  * DPT with down_ratio 2, no confidence, sigmoid and linear: f32, atol
    5e-3 on the outputs, 1e-4 relative to the largest parameter gradient;
  * CenterSnapConfig's model at the shipped bf16 trunk: the loss within
    1e-4 relative, the heatmap within 2e-2 and the pose map within 5e-2
    (bf16 tokens), and the gradient of all leaves together within 1e-2 of
    JAX's (relative L2 norm; both sides sit ~2e-3 from the f32 trunk's
    gradient, and the port no further from it than twice JAX's own bf16
    error). Port-side attention on the CPU is attention_plain (f32 logits)
    and JAX's CPU route the einsum with bf16 logits, so the bf16 gradients
    cannot agree leaf by leaf: a leaf whose gradient cancels over pixels
    (the L1 pose term's signs) moves far in relative terms;
  * the ResNet-FPN baseline (its trunk cut to 1, 1, 2, 1 bottlenecks a
    stage): f32, the forward within 1e-4, the loss within 1e-5 relative and
    the gradients of one training step within 1e-4 of the largest; the
    default config's parameter tree is JAX's, leaf for leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import close, normal, state_dict_np, t, uniform
from hunyuanworld_mirror_tpu.models import aggregator as jagg
from hunyuanworld_mirror_tpu.models import centersnap as jcs
from hunyuanworld_mirror_tpu.models import dinov2 as jdino
from hunyuanworld_mirror_tpu.models import dpt as jdpt
from hunyuanworld_mirror_tpu.models import panoptic as jpan
from hunyuanworld_mirror_tpu.training import losses as jlosses
from hunyuanworld_mirror_tpu_torch import convert
from hunyuanworld_mirror_tpu_torch.models import aggregator as pagg
from hunyuanworld_mirror_tpu_torch.models import centersnap as pcs
from hunyuanworld_mirror_tpu_torch.models import dinov2 as pdino
from hunyuanworld_mirror_tpu_torch.models import dpt as pdpt
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.models import panoptic as ppan
from hunyuanworld_mirror_tpu_torch.training import losses as plosses
from tools import convert_weights as cw


def _init(module, seed=0):
    pnn.init_weights(module, torch.Generator().manual_seed(seed))
    return module


def _same_tree(a, b):
    assert jax.tree.structure(jax.tree.map(lambda _: 0, a)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, b))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _tiny_cs(**kw):
    base = dict(img_size=64, patch_size=16, embed_dim=32, trunk_depth=2,
                trunk_heads=2, heatmap_features=16)
    base.update(kw)
    return base


@pytest.mark.parametrize("depth,idxs,cond", [
    (2, (0, 0, 1, 1), True),      # CenterSnap's capture at depth 2: repeats
    (4, (0, 1, 1, 2), False),     # a layer after the last capture still runs
])
@pytest.mark.parametrize("patch_embed", ["conv", "conv_mlp"])
def test_frame_only_trunk_f32(depth, idxs, cond, patch_embed):
    cfg = dict(img_size=48, patch_size=16, embed_dim=32, depth=depth, num_heads=2,
               patch_embed=patch_embed, enable_cond=cond, frame_only=True,
               intermediate_idxs=idxs)
    mod = _init(pagg.VisualGeometryTransformer(pagg.VGTConfig(**cfg)))
    assert mod.global_blocks is None
    params = cw.convert_vgt(state_dict_np(mod))
    assert "global_blocks" not in params
    _same_tree(convert.to_jax_tree(mod), params)
    imgs = uniform(1, (2, 1, 48, 48, 3))
    depth_map = uniform(2, (2, 1, 48, 48))
    priors = (depth_map, None, None) if cond else None
    flags = (0, 1, 0) if cond else (0, 0, 0)
    with torch.no_grad():
        out, start = mod(t(imgs), (t(depth_map), None, None) if cond else None,
                         flags, dtype=torch.float32)
    ref, ref_start = jagg.forward(
        params, jagg.VGTConfig(**cfg), jnp.asarray(imgs),
        priors=None if priors is None else tuple(
            None if p is None else jnp.asarray(p) for p in priors),
        cond_flags=flags, dtype=jnp.float32)
    assert start == ref_start and len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        assert a.shape == b.shape == (2, 1, 9 + start, 32)
        close(a, b, 2e-4)


@pytest.mark.parametrize("kind", ["giant2", "dinov3_vits16"])
def test_encoder_variants_f32(kind):
    factory = {"giant2": "dinov2_vitg2_reg", "dinov3_vits16": "dinov3_vits16"}[kind]
    base = pdino.VIT_FACTORIES[factory]
    assert dataclasses.asdict(base) == dataclasses.asdict(jdino.VIT_FACTORIES[factory])
    tiny = dict(img_size=48, embed_dim=32, depth=2, num_heads=2)
    pcfg = dataclasses.replace(base, **tiny)
    jcfg = dataclasses.replace(jdino.VIT_FACTORIES[factory], **tiny)
    enc = _init(pdino.DinoVisionTransformer(pcfg), seed=3)
    params = cw.convert_dinov2(state_dict_np(enc))
    if kind == "giant2":
        assert "w12" in params["blocks"]["mlp"]
    imgs = normal(4, (2, 48, 48, 3))
    with torch.no_grad():
        out = enc.forward_features(t(imgs))
    ref = jdino.forward_features(params, jcfg, jnp.asarray(imgs), dtype=jnp.float32)
    close(out, ref, 2e-4)


@pytest.mark.parametrize("activation,down_ratio,pos_embed", [
    ("sigmoid", 1, True), ("linear", 2, True), ("linear", 2, False)])
def test_dpt_fork_switches(activation, down_ratio, pos_embed):
    c = dict(dim_in=32, patch_size=16, output_dim=12, activation=activation,
             features=16, out_channels=(32, 64, 64, 64), with_conf=False,
             down_ratio=down_ratio, pos_embed=pos_embed)
    head = _init(pdpt.DPTHead(pdpt.DPTConfig(**c)), seed=1)
    params = cw.convert_dpt(state_dict_np(head))
    _same_tree(convert.to_jax_tree(head), params)
    toks = [normal(10 + i, (2, 1, 7 + 16, 32)) for i in range(4)]
    imgs = uniform(5, (2, 1, 64, 64, 3))
    w = normal(6, (2, 1, 64 // down_ratio, 64 // down_ratio, 12))

    def f(p):
        preds, conf = jdpt.forward(p, jdpt.DPTConfig(**c), [jnp.asarray(x) for x in toks],
                                   jnp.asarray(imgs), 7)
        return jnp.sum(preds * w), (preds, conf)

    (_, (ref, ref_conf)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    preds, conf = head([t(x) for x in toks], t(imgs), 7)
    assert conf is None and ref_conf is None
    close(preds, ref, 5e-3)
    (preds * t(w)).sum().backward()
    ours = convert.to_jax_tree(head, {n: p.grad for n, p in head.named_parameters()})
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(grads))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(grads)):
        close(a, b, 1e-4 * scale)


def _cs_batch(seed, B=2, H=64):
    return {"rgb": uniform(seed, (B, H, H, 3)), "depth": uniform(seed + 1, (B, H, H)),
            "heatmap": uniform(seed + 2, (B, H, H)),
            "pose_map": normal(seed + 3, (B, H // 2, H // 2, 12))}


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(a, np.float32)) for a in jax.tree.leaves(tree)])


def test_centersnap_loss_and_grads_bf16():
    cfg = _tiny_cs()
    pcfg, jcfg = pcs.CenterSnapConfig(**cfg), jcs.CenterSnapConfig(**cfg)
    assert pcfg.vgt == pagg.VGTConfig(**dataclasses.asdict(jcfg.vgt))
    model = _init(pcs.CenterSnap(pcfg))
    sd = state_dict_np(model)
    params = {"encoder": cw.convert_vgt(sd, "encoder."),
              "heatmap_head": cw.convert_dpt(sd, "heatmap_head."),
              "pose_head": cw.convert_dpt(sd, "pose_head.")}
    _same_tree(convert.to_jax_tree(model), params)
    b = _cs_batch(7)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def shipped(p):   # centersnap.forward: the trunk in bf16
        preds = jcs.forward(p, jcfg, jb["rgb"], jb["depth"])
        return jlosses.centersnap_loss(preds, jb)[0], preds

    def f32_trunk(p):
        imgs = jb["rgb"][:, None]
        toks, start = jagg.forward(p["encoder"], jcfg.vgt, imgs,
                                   priors=(jb["depth"][:, None], None, None),
                                   cond_flags=(0, 1, 0), dtype=jnp.float32)
        heat, _ = jdpt.forward(p["heatmap_head"], jcfg.heatmap_head, toks, imgs, start)
        pose, _ = jdpt.forward(p["pose_head"], jcfg.pose_head, toks, imgs, start)
        return jlosses.centersnap_loss({"heatmap": heat[:, 0], "pose_map": pose[:, 0]}, jb)[0]

    (ref_loss, ref_preds), ref_g = jax.jit(jax.value_and_grad(shipped, has_aux=True))(params)
    f32_g = jax.jit(jax.grad(f32_trunk))(params)

    preds = model(t(b["rgb"]), t(b["depth"]))
    loss, _ = plosses.centersnap_loss(preds, {k: t(v) for k, v in b.items()})
    loss.backward()
    close(loss, ref_loss, 1e-4 * abs(float(ref_loss)))
    close(preds["heatmap"], ref_preds["heatmap"], 2e-2)
    close(preds["pose_map"], ref_preds["pose_map"], 5e-2)
    grads = convert.to_jax_tree(model, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()})
    g, rg, fg = _flat(grads), _flat(ref_g), _flat(f32_g)
    norm = np.linalg.norm(fg)
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - rg) <= 1e-2 * norm
    assert np.linalg.norm(g - fg) <= 2 * np.linalg.norm(rg - fg) + 1e-6 * norm


def test_centersnap_dinov3_encoder_forward():
    """patch_embed="dinov3_vits16": the DINOv3 encoder (12 blocks, width
    384, RoPE) under the frame-only trunk, f32 trunk, on a 32 px image."""
    cfg = _tiny_cs(img_size=32, embed_dim=384, trunk_heads=6, trunk_depth=1,
                   patch_embed="dinov3_vits16", use_depth_condition=False)
    pcfg, jcfg = pcs.CenterSnapConfig(**cfg), jcs.CenterSnapConfig(**cfg)
    model = _init(pcs.CenterSnap(pcfg), seed=2)
    params = convert.to_jax_tree(model)
    init = jax.eval_shape(lambda: jagg.init(jax.random.PRNGKey(0), jcfg.vgt))
    _same_tree(jax.tree.map(np.shape, params["encoder"]),
               jax.tree.map(lambda a: a.shape, init))
    rgb = uniform(8, (1, 32, 32, 3))
    with torch.no_grad():
        toks, _ = model.encoder(t(rgb)[:, None], dtype=torch.float32)
    ref, _ = jax.jit(lambda p, x: jagg.forward(p, jcfg.vgt, x, dtype=jnp.float32))(
        params["encoder"], jnp.asarray(rgb)[:, None])
    for a, b in zip(toks, ref):
        close(a, b, 2e-4)


# the ResNet-FPN trunk cut to (1, 1, 2, 1) bottlenecks a stage at 64 px
SMALL_PAN = ppan.PanopticConfig(blocks_per_stage=(1, 1, 2, 1))


def test_panoptic_tree_matches_jax_init():
    model = ppan.Panoptic(ppan.PanopticConfig())
    init = jax.eval_shape(lambda: jpan.init(jax.random.PRNGKey(0), jpan.PanopticConfig()))
    _same_tree(jax.tree.map(np.shape, convert.to_jax_tree(model)),
               jax.tree.map(lambda a: a.shape, init))


def test_panoptic_forward_and_one_step():
    from hunyuanworld_mirror_tpu_torch.training import trainer as ptrainer
    model = _init(ppan.Panoptic(SMALL_PAN), seed=5)
    params = convert.to_jax_tree(model)
    b = _cs_batch(21, B=1, H=64)
    b["rgb"] = normal(25, (1, 64, 64, 3))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jcfg = jpan.PanopticConfig(blocks_per_stage=SMALL_PAN.blocks_per_stage)

    def f(p):
        preds = jpan.forward(p, jcfg, jb["rgb"], jb["depth"])
        return jlosses.centersnap_loss(preds, jb)[0], preds

    (ref_loss, ref), ref_g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    opt = ptrainer.AdamWCosine(model, 1e-3, 10, 0.05)
    tcfg = ptrainer.TrainConfig(arch="res_fpn", model=SMALL_PAN)
    batch = {k: t(v) for k, v in b.items()}
    with torch.no_grad():
        out = model(batch["rgb"], batch["depth"])
    for k in ("heatmap", "pose_map", "small_disp"):
        assert out[k].shape == ref[k].shape
        close(out[k], ref[k], 1e-4, err_msg=k)
    loss, _ = ptrainer.make_train_step(tcfg, model, opt)(batch)
    close(loss, ref_loss, 1e-5 * abs(float(ref_loss)))
    grads = convert.to_jax_tree(model, {n: p.grad for n, p in model.named_parameters()})
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(ref_g))
    for a, r in zip(jax.tree.leaves(grads), jax.tree.leaves(ref_g)):
        close(a, r, 1e-4 * scale)
    assert opt.count == 1
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(convert.to_jax_tree(model)))
