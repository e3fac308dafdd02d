"""Port vs JAX: the camera head, the DPT heads (plain and Gaussian variant,
each activation) and the align-corners bilinear resize, at f32. Bands: the
dense heads at compare_heads' atol 5e-3 / rtol 5e-3
(tests/test_full_model_parity.py), the camera head and the resize at 1e-4."""

import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import close, normal, state_dict_np, t, uniform
from hunyuanworld_mirror_tpu.models import camera_head as jcam
from hunyuanworld_mirror_tpu.models import dpt as jdpt
from hunyuanworld_mirror_tpu.ops import interpolate as jinterp
from hunyuanworld_mirror_tpu_torch.models import camera_head as pcam
from hunyuanworld_mirror_tpu_torch.models import dpt as pdpt
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.ops import interpolate as pinterp
from tools import convert_weights as cw

HEAD_BAND = dict(atol=5e-3, rtol=5e-3)


def _tokens(seed, dim, B=1, S=2, n=7 + 16):
    return [normal(seed + i, (B, S, n, dim)) for i in range(4)]


def test_camera_head():
    cfg_kw = dict(dim_in=128, num_heads=2)
    head = pcam.CameraHead(pcam.CameraHeadConfig(**cfg_kw))
    pnn.init_weights(head, torch.Generator().manual_seed(0))
    params = cw.convert_camera_head(state_dict_np(head))
    toks = _tokens(0, 128, S=3)
    with torch.no_grad():
        out = head([t(x) for x in toks])
    ref = jcam.forward(params, jcam.CameraHeadConfig(**cfg_kw),
                       [jnp.asarray(x) for x in toks])
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        close(o, r, 1e-4)


@pytest.mark.parametrize("output_dim,activation,is_gsdpt", [
    (4, "inv_log+expp1", False), (2, "exp+expp1", False),
    (4, "norm+expp1", False), (2, "exp+expp1", True)])
def test_dpt_head(output_dim, activation, is_gsdpt):
    kw = dict(dim_in=128, output_dim=output_dim, activation=activation,
              features=32, out_channels=(32, 48, 64, 64), is_gsdpt=is_gsdpt)
    head = pdpt.DPTHead(pdpt.DPTConfig(**kw))
    pnn.init_weights(head, torch.Generator().manual_seed(1))
    params = cw.convert_dpt(state_dict_np(head), is_gsdpt=is_gsdpt)
    toks = _tokens(10, 128)
    imgs = uniform(11, (1, 2, 56, 56, 3))
    with torch.no_grad():
        out = head([t(x) for x in toks], t(imgs), 7)
    ref = jdpt.forward(params, jdpt.DPTConfig(**kw), [jnp.asarray(x) for x in toks],
                       jnp.asarray(imgs), 7)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        close(o, r, **HEAD_BAND)


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((7, 5), (16, 11)),
                                     ((9, 9), (4, 6)), ((6, 6), (6, 6))])
def test_resize_bilinear(src, dst):
    x = normal(12, (2, *src, 5))
    close(pinterp.resize_bilinear(t(x), dst),
          jinterp.resize_bilinear(jnp.asarray(x), dst, align_corners=True), 1e-5)
