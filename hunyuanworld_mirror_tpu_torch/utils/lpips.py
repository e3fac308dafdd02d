"""LPIPS perceptual distance (AlexNet backbone + linear heads) in PyTorch.

Port of hunyuanworld_mirror_tpu/utils/lpips.py, which follows the `lpips`
package's `LPIPS(net="alex")` (Zhang et al., CVPR 2018). The math is the
JAX module's, not the package's: inputs in [0, 1] go to 2x - 1, then
(x - shift) / scale; AlexNet's five convs with a 3 x 3 stride-2 VALID max
pool before conv2 and conv3; each feature map divided by max(‖x‖, 1e-10)
over channels; the heads' weights clamped at 0; each head's map averaged
over (H, W) and the five summed.

The published metric needs the pretrained AlexNet and calibrated heads,
which are not in this repository. `convert_torch_state` maps the `lpips`
package's state dict onto the JAX package's pytree (the layout of its npz
files); `load_params` reads such an npz from `path` or $WM_LPIPS_WEIGHTS
and returns None when neither names a file, and metric reports then omit
LPIPS. `init_random` gives a structurally identical net for tests.

Layout: images (B, H, W, 3) in [0, 1]; NCHW inside, OIHW conv weights.
"""

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import convert

# (out_ch, kernel, stride, pad) of torchvision AlexNet `features` convs
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1)]
_CHANNELS = [64, 192, 384, 256, 256]

# lpips.ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """AlexNet's five convs (`convs.{i}`) and the five linear heads
    (`lins.{i}`, 1 x 1 convs of one output, no bias)."""

    def __init__(self, device=None):
        super().__init__()
        cins = [3] + _CHANNELS[:-1]
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, k, stride=s, padding=p, device=device)
            for cin, (cout, k, s, p) in zip(cins, _ALEX))
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False, device=device)
                                  for c in _CHANNELS)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) in [0, 1] -> the five ReLU feature maps (NCHW)."""
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        x = 2.0 * x - 1.0
        x = ((x - shift) / scale).permute(0, 3, 1, 2)
        feats = []
        for i, conv in enumerate(self.convs):
            if i in (1, 2):  # maxpool k3 s2 precedes conv2 and conv3
                x = F.max_pool2d(x, 3, 2) if min(x.shape[-2:]) >= 3 else x[..., :0, :0]
            x = F.relu(_conv(conv, x))
            feats.append(x)
        return feats


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """conv(x), or the empty map XLA's convolution gives where the image is
    too small for the window (under 31 px the later maps are empty and the
    distance is NaN, as in JAX; torch would raise)."""
    (k, _), (s, _), (p, _) = conv.kernel_size, conv.stride, conv.padding
    h, w = ((n + 2 * p - k) // s + 1 for n in x.shape[-2:])
    if min(h, w, *x.shape[-2:]) <= 0:
        return x.new_zeros(x.shape[0], conv.out_channels, max(h, 0), max(w, 0))
    return conv(x)


def init_random(generator: Optional[torch.Generator] = None, device=None) -> LPIPS:
    """Random weights with the production structure, drawn as the JAX
    init_random draws them (testing only — NOT the calibrated metric): the
    convs kaiming-uniform with bound sqrt(1 / fan_in) and their biases
    uniform in ±1/sqrt(fan_in), the heads uniform in [0, 0.1)."""
    model = LPIPS(device=device)
    with torch.no_grad():
        for conv in model.convs:
            fan_in = conv.weight[0].numel()
            bound = fan_in ** -0.5
            conv.weight.uniform_(-bound, bound, generator=generator)
            conv.bias.uniform_(-bound, bound, generator=generator)
        for lin in model.lins:
            lin.weight.uniform_(0.0, 0.1, generator=generator)
    return model


def convert_torch_state(sd: Dict[str, np.ndarray]) -> Dict:
    """Map the `lpips` package state dict (plus AlexNet features) to the JAX
    package's params pytree (HWIO kernels), as its converter does.

    Accepts either naming scheme:
      net.slice{i}.{j}.weight  (lpips package submodule slices)
      features.{j}.weight      (raw torchvision AlexNet)
    plus lin{i}.model.1.weight for the linear heads.
    """
    # feature-module indices of the five convs inside torchvision AlexNet
    feat_idx = [0, 3, 6, 8, 10]
    slice_local = {0: (1, 0), 1: (2, 1), 2: (3, 1), 3: (4, 0), 4: (5, 0)}

    def conv_w(i):
        for k in (f"features.{feat_idx[i]}.weight",
                  f"net.slice{slice_local[i][0]}.{feat_idx[i]}.weight"):
            if k in sd:
                return k
        raise KeyError(f"conv{i} weights not found in state dict")

    params = {"convs": [], "lins": []}
    for i in range(5):
        wk = conv_w(i)
        bk = wk.replace("weight", "bias")
        params["convs"].append({
            "w": np.asarray(sd[wk]).transpose(2, 3, 1, 0).copy(),
            "b": np.asarray(sd[bk]).copy(),
        })
    for i in range(5):
        w = np.asarray(sd[f"lin{i}.model.1.weight"])  # (1, C, 1, 1)
        params["lins"].append({"w": w.transpose(2, 3, 1, 0).copy()})
    return params


def as_module(params, device=None) -> LPIPS:
    """An LPIPS module on `device`: `params` itself if it is one, else the
    JAX pytree `params` (numpy leaves) loaded into a new module."""
    if isinstance(params, LPIPS):
        return params.to(device)
    model = LPIPS(device=device)
    model.load_state_dict(convert.lpips_from_jax_params(params))
    return model


def distance(model: LPIPS, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per image pair; a, b (B, H, W, 3) in [0, 1] -> (B,)."""
    total = 0.0
    for xa, xb, lin in zip(model.features(a), model.features(b), model.lins):
        na = xa / torch.clamp(torch.linalg.vector_norm(xa, dim=1, keepdim=True),
                              min=1e-10)
        nb = xb / torch.clamp(torch.linalg.vector_norm(xb, dim=1, keepdim=True),
                              min=1e-10)
        d = (na - nb) ** 2
        w = torch.clamp(lin.weight, min=0.0)  # heads are nonneg
        if min(d.shape[-2:]) > 0:
            total = total + F.conv2d(d, w.to(d.dtype)).mean(dim=(1, 2, 3))
        else:  # an empty map: JAX's mean over no pixels
            total = total + d.new_full((d.shape[0],), float("nan"))
    return total


def load_params(path: Optional[str] = None) -> Optional[Dict]:
    """Converted weights (the JAX pytree, numpy leaves) from `path` or
    $WM_LPIPS_WEIGHTS; None if the gate is closed (no weights here)."""
    path = path or os.environ.get("WM_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    from ..training import checkpoint as ckpt
    return ckpt.load_params(path)
