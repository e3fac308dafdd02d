"""Bilinear resize with align_corners=True.

Port of hunyuanworld_mirror_tpu/ops/interpolate.py, which builds the 1-D
interpolation operators as matrices for the TPU; F.interpolate computes the
same function. Takes NHWC like the JAX function, or NCHW with `nchw=True`
(the layout the port's DPT decoder runs in).
"""

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, nchw: bool = False) -> torch.Tensor:
    out_h, out_w = size
    in_h, in_w = (x.shape[-2], x.shape[-1]) if nchw else (x.shape[-3], x.shape[-2])
    if (in_h, in_w) == (out_h, out_w):
        return x
    if nchw:
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=True)
    lead = x.shape[:-3]
    y = F.interpolate(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2),
                      size=(out_h, out_w), mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, x.shape[-1])
