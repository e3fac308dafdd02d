"""The port's measuring tools on the CPU: utils/profiling.py against the JAX
module (the FLOP and byte counters and roofline exactly equal for the same
arguments), detect_chip with torch.cuda stood in for, PhaseTimer / time_fn
on CPU tensors, trace writing its file, and the heads-profile twin's three
stages composed against the DPT head's forward at the tiny preset (1e-5)."""

import json

import numpy as np
import pytest
import torch

from torch_port_helpers import close
from hunyuanworld_mirror_tpu.utils import profiling as jprof
from hunyuanworld_mirror_tpu_torch import heads_profile
from hunyuanworld_mirror_tpu_torch.infer import PRESETS, load_model
from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig
from hunyuanworld_mirror_tpu_torch.utils import profiling as pprof

H100_NAME = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("fn,args", [
    ("attention_flops", (1, 1374, 16, 64)),
    ("attention_flops", (4, 5504, 16, 64)),
    ("attention_flops", (20, 581, 6, 64)),
    ("vgt_flops", (1, 2, 1376, 1024, 24)),
    ("vgt_flops", (1, 8, 1376, 1024, 24)),
    ("vgt_flops", (2, 4, 16, 64, 4)),
    ("rasterizer_bytes", (537088, 518 * 518, 1024, 1089, 4)),
    ("rasterizer_bytes", (150, 64 * 48, 2048, 12, 3)),
    ("rasterizer_bytes", (4096, 128 * 128, 37, 64, 1)),
])
def test_counters_equal_jax(fn, args):
    assert getattr(pprof, fn)(*args) == getattr(jprof, fn)(*args)


@pytest.mark.parametrize("flops,bytes_moved,seconds,dtype", [
    (1e12, 0.0, 4.36e-3, "bf16"),
    (1e9, 3.35e12 * 1e-3, 2e-3, "bf16"),
    (5.4e12, 2e9, 0.19, "f32"),
])
def test_roofline_equals_jax(flops, bytes_moved, seconds, dtype):
    spec = pprof.CHIP_SPECS["h100"]
    jspec = jprof.ChipSpec(spec.name, spec.peak_flops_bf16, spec.peak_flops_f32,
                           spec.hbm_bytes_per_s)
    ours = pprof.roofline(flops, bytes_moved, seconds, spec=spec, dtype=dtype)
    ref = jprof.roofline(flops, bytes_moved, seconds, spec=jspec, dtype=dtype)
    assert ours["chip"] == "h100"
    assert {k: v for k, v in ours.items() if k != "chip"} == {
        k: v for k, v in ref.items() if k != "chip"}


def test_h100_spec_is_the_data_sheet():
    spec = pprof.CHIP_SPECS["h100"]
    assert (spec.peak_flops_bf16, spec.peak_flops_f32, spec.hbm_bytes_per_s,
            spec.power_limit_w) == (989e12, 67e12, 3.35e12, 700.0)


def _card(monkeypatch, name, line=None):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    monkeypatch.setattr(pprof, "card_line", lambda: line or f"{name}, 700.00 W")


def test_detect_chip_maps_h100(monkeypatch):
    _card(monkeypatch, H100_NAME, f"{H100_NAME}, 450.00 W")
    spec, name, watts = pprof.detect_chip()
    assert spec is pprof.CHIP_SPECS["h100"] and name == H100_NAME and watts == 450.0


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"])
def test_detect_chip_refuses_other_cards(monkeypatch, name):
    _card(monkeypatch, name)
    with pytest.raises(RuntimeError, match="h100"):
        pprof.detect_chip()


def test_detect_chip_and_roofline_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pprof.detect_chip()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pprof.roofline(1e12, 0.0, 1.0)


def test_phase_timer_and_time_fn():
    timer = pprof.PhaseTimer()
    x = torch.ones(8, 8)
    with timer.phase("square", sync_value={"y": [x]}):
        _ = x * x
    timer.record("fixed", 0.01)
    assert timer.times["fixed"] == [0.01] and len(timer.times["square"]) == 1
    s = timer.summary()
    assert "square" in s and "fixed" in s
    calls = []
    t = pprof.time_fn(lambda a: calls.append(1) or a @ a, x, iters=3, warmup=2)
    assert t > 0 and len(calls) == 5


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with pprof.trace(str(tmp_path), cuda=False) as prof:
        (x @ x).sum()
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith("trace_")
    assert "traceEvents" in json.loads(files[0].read_text())
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.fixture(scope="module")
def tiny_model_tokens():
    cfg = WorldMirrorConfig(img_size=56, **PRESETS["tiny"])
    model = load_model(cfg, device="cpu").float()
    imgs = torch.tensor(np.random.default_rng(0).uniform(size=(1, 2, 56, 56, 3)),
                        dtype=torch.float32)
    with torch.no_grad():
        tokens, start = model.visual_geometry_transformer(imgs)
    return model, imgs, tokens, start


@pytest.mark.parametrize("head", ["pts_head", "depth_head", "norm_head"])
def test_heads_profile_stages_compose_to_the_head(tiny_model_tokens, head):
    model, imgs, tokens, start = tiny_model_tokens
    dpt = getattr(model, head)
    stage_tokens, stage_fusion, stage_fullres = heads_profile.stage_fns(dpt, imgs, start)
    with torch.no_grad():
        composed = stage_fullres(stage_fusion(stage_tokens(tokens)))
        preds, _ = dpt(tokens, imgs, start)
    assert composed.shape == preds.reshape(-1, *preds.shape[2:]).shape
    close(composed, preds.reshape(composed.shape), 1e-5)


def test_heads_profile_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        heads_profile.main(["--views", "2", "--img", "56"])
