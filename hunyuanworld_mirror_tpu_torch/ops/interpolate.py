"""Bilinear resize, align_corners=True by default.

Port of hunyuanworld_mirror_tpu/ops/interpolate.py, which builds the 1-D
interpolation operators as matrices for the TPU; F.interpolate computes the
same function (align_corners=False included: both clamp the source
coordinate to [0, in - 1]). Takes NHWC like the JAX function, or NCHW with
`nchw=True` (the layout the port's decoders run in).
"""

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, nchw: bool = False,
                    align_corners: bool = True) -> torch.Tensor:
    out_h, out_w = size
    in_h, in_w = (x.shape[-2], x.shape[-1]) if nchw else (x.shape[-3], x.shape[-2])
    if (in_h, in_w) == (out_h, out_w):
        return x
    if nchw:
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=align_corners)
    lead = x.shape[:-3]
    y = F.interpolate(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2),
                      size=(out_h, out_w), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, x.shape[-1])


def scale2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """scale_factor=2 resize of NHWC x (torch semantics: out = in * 2)."""
    return resize_bilinear(x, (x.shape[-3] * 2, x.shape[-2] * 2),
                           align_corners=align_corners)
