"""The frozen yardstick pinned at the recon cell's shapes (B=1, S=4,
518 px, WorldMirror large)."""

import json
import math

import numpy as np
import pytest

from wmbench.frozen import arith, peaks, scenes
from wmbench.tests.tiny import REPO


def test_model_flops_at_the_cell():
    f = arith.model_flops(1, 4, 518, 518, 1024, 256, 7)
    assert f["encoder"] == 4068410228736.0
    assert f["trunk"] == 10371138060288.0
    assert f["heads"] == 5416033021952.0
    assert f["total"] == 19855581310976.0


def test_attention_calls_at_the_cell():
    cfg = json.loads((REPO / "wmbench/configs/worldmirror_large.json").read_text())
    calls = arith.attention_calls(cfg, 1, 4)
    assert [(c.B, c.N, c.H, c.D, c.dtype, c.count) for c in calls] == [
        (4, 1374, 16, 64, "bf16", 24), (4, 1376, 16, 64, "bf16", 24),
        (1, 5504, 16, 64, "bf16", 24), (1, 4, 16, 128, "f32", 16)]
    assert arith.attention_flops(1, 5504, 16, 64) == 124084289536.0
    assert arith.attention_flops(4, 1374, 16, 64) == 30930960384.0


def test_rasterizer_bytes():
    assert arith.rasterizer_bytes(537088, 518 * 518, 4096, 1089, 4) == 183788240
    assert arith.k2_bytes(630000, 518 * 518, 4) == 30566480


def test_peaks():
    h = peaks.H100
    assert (h.peak_flops_bf16, h.peak_flops_f32, h.hbm_bytes_per_s, h.power_limit_w) == (
        989e12, 67e12, 3.35e12, 700.0)
    assert peaks.spec_for("NVIDIA H100 80GB HBM3") is h
    with pytest.raises(RuntimeError):
        peaks.spec_for("NVIDIA H100 PCIe")


def test_fixed_cameras():
    c = scenes.fixed_cameras(4)
    assert c.shape == (1, 4, 9) and c.dtype == np.float32
    a = 0.05 * 3
    np.testing.assert_array_equal(
        c[0, 3], np.float32([0.15, -0.06, 0.09, 0.0, math.sin(a / 2), 0.0,
                             math.cos(a / 2), math.radians(60), math.radians(60)]))
    np.testing.assert_array_equal(c[0, 0, :7], np.float32([0, 0, 0, 0, 0, 0, 1]))
