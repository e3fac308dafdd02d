"""The control: the reference put in the program's place one precision
step lower (fp8 trunk, TF32 heads, bf16 render) must come out not correct
under the cell's limits. At a tiny size on the CPU here; at the cell's own
size on the card (marker `card`), where its readings set the limits'
upper ends (PERF.md)."""

import math

import pytest
import torch

from wmbench import control, run
from wmbench.systems import worldmirror as wmb
from wmbench.reference.weights import make_weights
from wmbench.tests import tiny
from wmbench.traffic import scenes


def _fails(nums, limits):
    return any(not math.isfinite(v) or v > limits[k] for k, v in nums.items())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct_tiny(seed):
    p = tiny.parts()
    data = scenes.make(p.traffic, seed)
    sd = {k: v.float() for k, v in make_weights(p.cfg, seed, "cpu").items()}
    img, cams = torch.as_tensor(data["scenes"][0]), torch.as_tensor(data["cameras"])
    out, toks = wmb.control_outputs(sd, p.cfg, img, cams)
    nums = wmb.compare(sd, p.cfg, img, cams, out, toks)
    assert _fails(nums, p.limits)
    assert nums["heads_gap"] > p.limits["heads_gap"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["recon.large.s4", "recon.large.s32"])
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    parts = run.cell_parts(run.manifest(tiny.REPO), cell)
    for seed in (11, 12, 13):
        assert _fails(control.control_numbers(parts, seed, "cuda"), parts.limits)
