"""The port's measuring tools on the CPU: utils/profiling.py against the JAX
module (the FLOP and byte counters and roofline exactly equal for the same
arguments), detect_chip with torch.cuda stood in for, time_fn on CPU
tensors, the span-and-counter recorder (nesting, parents, request ids,
counters on the innermost span, the shared no-op context while off, the
`marks` entries, nested user annotations under torch.profiler), and the
heads-profile twin's three stages composed against the DPT head's forward
at the tiny preset (1e-5)."""

import json

import numpy as np
import pytest
import torch

from torch_port_helpers import close
from hunyuanworld_mirror_tpu.utils import profiling as jprof
from hunyuanworld_mirror_tpu_torch import heads_profile
from hunyuanworld_mirror_tpu_torch.infer import PRESETS, load_model, reconstruct
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
    """time_fn (PhaseTimer went with its last caller; the recorder's tests
    below time phases now)."""
    x = torch.ones(8, 8)
    calls = []
    t = pprof.time_fn(lambda a: calls.append(1) or a @ a, x, iters=3, warmup=2)
    assert t > 0 and len(calls) == 5


def _tree(rec):
    """Each request's spans as (name, parent name, request id)."""
    return [[(s.name, s.parent.name if s.parent else None, s.request) for s in r.spans]
            for r in rec.resolve()]


def test_spans_nest_with_parents_and_request_ids():
    with pprof.recording() as rec:
        with pprof.request():
            with pprof.span("a"):
                with pprof.span("a.x"):
                    pass
                with pprof.span("a.y"):
                    with pprof.span("a.y.z"):
                        pass
            with pprof.span("b"):
                pass
        with pprof.span("outside"):       # a request of its own
            with pprof.span("outside.in"):
                pass
        with pprof.request():
            with pprof.request():          # joins the open request
                with pprof.span("c"):
                    pass
    assert _tree(rec) == [
        [("a", None, 0), ("a.x", "a", 0), ("a.y", "a", 0), ("a.y.z", "a.y", 0),
         ("b", None, 0)],
        [("outside", None, 1), ("outside.in", "outside", 1)],
        [("c", None, 2)]]
    a, ax = rec.requests[0].spans[:2]
    assert a.ms >= ax.ms >= 0.0
    assert rec.requests[0].ms("a.x", "a.y") == ax.ms + rec.requests[0].spans[2].ms


def test_counters_land_on_the_innermost_span():
    with pprof.recording() as rec:
        with pprof.request():
            pprof.count("host_syncs")            # no span open: the request's only
            with pprof.span("a"):
                pprof.count("host_syncs", 2)
                with pprof.span("a.x"):
                    pprof.count("host_syncs")
                    pprof.count("other", 5)
                pprof.count("host_syncs")
    req = rec.requests[0]
    a, ax = req.spans
    assert a.counts == {"host_syncs": 3}
    assert ax.counts == {"host_syncs": 1, "other": 5}
    assert req.counts == {"host_syncs": 5, "other": 5}


def test_off_span_is_one_shared_noop_and_records_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(pprof, "Span", lambda *a: made.append(a))
    before = pprof.marked.n_requests
    first = pprof.span("a")
    assert first is pprof.span("b") is pprof.request() is pprof.request(None, start=True)
    with first as inner:
        assert inner is None
        pprof.count("host_syncs", 3)
    assert made == [] and pprof.marked.n_requests == before
    assert pprof._recorder is None


def test_request_marks_get_the_top_level_end_events():
    marks = []
    before = pprof.marked.n_requests
    with pprof.request(marks, start=True):
        with pprof.span("one"):
            with pprof.span("one.child"):
                pass
        with pprof.request(marks):             # a nested request joins
            with pprof.span("two"):
                pass
    assert [n for n, _ in marks] == ["start", "one", "two"]
    req = pprof.marked.requests[-1]
    assert pprof.marked.n_requests == before + 1
    assert [s.name for s in req.spans] == ["one", "one.child", "two"]
    assert marks[0][1] is req.spans[0].start and marks[1][1] is req.spans[0].end
    assert marks[2][1] is req.spans[2].end
    assert marks[0][1].elapsed_time(marks[2][1]) >= marks[0][1].elapsed_time(marks[1][1]) >= 0
    assert pprof._recorder is None


def test_marked_keeps_the_latest_requests():
    rec = pprof.Recorder(keep=3)
    with pprof.recording(rec):
        for i in range(5):
            with pprof.span(f"r{i}"):
                pass
    assert [r.spans[0].name for r in rec.requests] == ["r2", "r3", "r4"]
    assert rec.n_requests == 5 and pprof.marked.requests.maxlen == pprof.MARKED_KEEP


class _Event:
    """A stand-in CUDA event: complete once `done`."""
    clock, done = 0.0, False

    def __init__(self):
        _Event.clock += 1.0
        self.t = _Event.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


def test_finished_requests_let_their_events_go(monkeypatch):
    """Each new request turns the stamps of the requests the card has
    finished into ms, oldest first, stopping at one it has not; resolve
    synchronises once for the rest."""
    made = []
    rec = pprof.Recorder()
    rec.cuda = True
    monkeypatch.setattr(rec, "stamp", lambda: made.append(_Event()) or made[-1])
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(1) or [
        setattr(e, "done", True) for e in made])
    with pprof.recording(rec):
        for name in ("a", "b"):
            with pprof.request():
                with pprof.span(name):
                    with pprof.span(name + ".x"):
                        pass
        for e in made[:4]:                  # the card has passed request a
            e.done = True
        with pprof.request():
            with pprof.span("c"):
                pass
    a, b, c = rec.requests
    assert [s.ms for s in a.spans] == [3.0, 1.0]
    assert all(s.start is None and s.end is None for s in a.spans)
    assert all(s.ms is None and s.end is not None for s in b.spans + c.spans)
    assert synced == []
    rec.resolve()
    assert synced == [1] and [s.ms for s in b.spans + c.spans] == [3.0, 1.0, 1.0]


def test_spans_are_nested_user_annotations_under_the_profiler(tmp_path):
    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pprof.recording():
            with pprof.span("outer"):
                with pprof.span("outer.inner"):
                    (x @ x).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ann = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation"}
    outer, inner = ann["outer"], ann["outer.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


# The spans a tiny reconstruct (S=2, fixed cameras) records: render.* once a
# camera, and where the host syncs land (55 on the card's S=4 request, two
# cameras more); each camera's projection takes kernel K6's route, and its
# binning K7's, whose plain version sorts the 3,584 splats x 4 slots; each
# of the 4 frame and 4 global blocks counts K8's route once (its q/k norm
# and RoPE).
TINY_TREE = (
    [("encoder", None, 2), ("trunk", None, 4), ("heads", None, 1),
     ("heads.depth", "heads", 10), ("heads.pts", "heads", 10),
     ("heads.normals", "heads", 10), ("heads.gs", "heads", 10),
     ("gs_render", None, 0), ("gs_render.splats", "gs_render", 3)]
    + [("render.project", "gs_render", 0), ("render.bin", "gs_render", 1),
       ("render.blend", "gs_render", 0)] * 2)
TINY_SYNCS = 53      # the tree's 52 and the images' upload
TINY_COUNTS = {"host_syncs": TINY_SYNCS, "project_fused": 2, "bin_fused": 2,
               "bin_rows": 2 * 3584 * 4, "norm_fused": 4 * 2}


@pytest.fixture(scope="module")
def tiny_scene():
    from hunyuanworld_mirror_tpu_torch.utils.scenes import fixed_cameras
    model = load_model(WorldMirrorConfig(img_size=56, **PRESETS["tiny"]), device="cpu")
    imgs = np.random.default_rng(1).uniform(size=(1, 2, 56, 56, 3)).astype(np.float32)
    return model, imgs, fixed_cameras(2)


def _spans(req):
    return [(s.name, s.parent.name if s.parent else None, s.counts.get("host_syncs", 0))
            for s in req.spans]


def test_tiny_reconstruct_records_the_span_tree(tiny_scene):
    model, imgs, cams = tiny_scene
    with pprof.recording() as rec:
        reconstruct(model, imgs, cams)
    (req,) = rec.resolve()
    assert _spans(req) == TINY_TREE
    assert req.counts == TINY_COUNTS
    assert all(s.ms >= 0 and s.request == req.id for s in req.spans)


def test_tiny_reconstruct_marks_are_the_parents(tiny_scene):
    """The marks list: the parent's names in its order, each entry the end
    event of the top-level span of that name (the first: the start of the
    first one); the request's whole tree lands in `marked`."""
    model, imgs, cams = tiny_scene
    marks = []
    reconstruct(model, imgs, cams, marks=marks)
    assert [n for n, _ in marks] == ["start", "encoder", "trunk", "heads", "gs_render"]
    req = pprof.marked.requests[-1]
    top = [s for s in req.spans if s.parent is None]
    assert marks[0][1] is top[0].start
    assert [ev for _, ev in marks[1:]] == [s.end for s in top]
    assert _spans(req) == TINY_TREE and req.counts == TINY_COUNTS


def _refine_step(bilateral=False):
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    rng = np.random.default_rng(0)
    n, S, W = 40, 2, 32
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    means[:, 2] += 2.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    splats = {"means": means, "quats": quats / np.linalg.norm(quats, axis=-1, keepdims=True),
              "scales": rng.uniform(0.02, 0.08, size=(n, 3)).astype(np.float32),
              "opacities": rng.uniform(0.3, 0.9, size=n).astype(np.float32),
              "sh": (rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32)}
    cfg = splat_opt.SplatOptConfig(max_per_tile=512, use_bilateral_grid=bilateral)
    raw = splat_opt._raw_from_splats({k: torch.tensor(v) for k, v in splats.items()}, 64)
    if bilateral:
        raw["bil_grids"] = splat_opt.bilagrid.init_bilateral_grids(
            S, *cfg.bilateral_grid_shape, device="cpu")
    opt = splat_opt.make_optimizer(cfg, raw, 1.0)
    aux = splat_opt.make_aux_optimizers(cfg, raw)
    step = splat_opt.make_train_step(cfg, W, W, 1.0, device="cpu")
    c2w = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    c2w[1, 0, 3] = 0.1
    K = torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]]).expand(S, 3, 3)
    vm = splat_opt.cam_utils.se3_inverse(torch.tensor(c2w))
    gt = torch.tensor(rng.uniform(size=(S, W, W, 3)).astype(np.float32))
    return lambda marks=None: step(raw, opt, vm, K, gt, None, marks, aux)


STEP_TREE = ([("render_forward", None, 0)]
             + [("render.project", "render_forward", 0), ("render.bin", "render_forward", 1),
                ("render.blend", "render_forward", 0)] * 2
             + [("loss", "render_forward", 0), ("backward", None, 0), ("optimizer", None, 0)])


def test_tiny_refine_step_records_the_span_tree():
    """One refinement step: render.* once a camera inside render_forward,
    the loss there too, then backward and optimizer; host syncs: each
    camera's depth scalar (the card's step adds the absgrad scale: 5 at 4
    cameras); each camera's projection takes kernel K6's route, and its
    binning K7's, whose plain version sorts the 64 slots x 9."""
    step = _refine_step()
    with pprof.recording() as rec:
        step()
    (req,) = rec.resolve()
    assert _spans(req) == STEP_TREE
    assert req.counts == {"host_syncs": 2, "project_fused": 2, "bin_fused": 2,
                          "bin_rows": 2 * 64 * 9}


@pytest.mark.parametrize("bilateral,names", [
    (False, ["start", "render_forward", "backward", "optimizer"]),
    (True, ["start", "rasterize", "bilagrid", "render_forward", "backward", "optimizer"]),
])
def test_tiny_refine_step_marks_are_the_parents(bilateral, names):
    """The step's marks after a caller's own start event, as the parent
    filled them; no child span enters the list."""
    step = _refine_step(bilateral)
    marks = [("start", pprof.HostStamp())]
    step(marks)
    assert [n for n, _ in marks] == names
    req = pprof.marked.requests[-1]
    assert [ev for _, ev in marks[1:]] == [s.end for s in req.spans if s.parent is None]
    assert "loss" in [s.name for s in req.spans]


def test_tracing_off_makes_no_event_and_no_record_function(tiny_scene, monkeypatch):
    """With tracing off, a tiny request and a refinement step create no
    CUDA event, enter no record_function and record nothing."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append("event"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append("record_function"))
    before = pprof.marked.n_requests
    model, imgs, cams = tiny_scene
    reconstruct(model, imgs, cams)
    _refine_step()()
    assert made == [] and pprof.marked.n_requests == before and pprof._recorder is None


def _centersnap_iteration():
    """One iteration of the 6D-pose trainer's loop (train_iteration) at a
    tiny CenterSnap (the conv patch embed, 32 px, B=2, depth condition)."""
    from hunyuanworld_mirror_tpu_torch.models import centersnap
    from hunyuanworld_mirror_tpu_torch.training import trainer
    cfg = trainer.TrainConfig(model=centersnap.CenterSnapConfig(
        img_size=32, embed_dim=32, trunk_depth=2, trunk_heads=2, heatmap_features=16))
    model = trainer.model_init(cfg, "cpu")
    step = trainer.make_train_step(cfg, model, trainer.make_optimizer(cfg, model))
    rng = np.random.default_rng(0)
    host = {"rgb": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
            "depth": rng.uniform(0, 25, (2, 32, 32)).astype(np.float32),
            "heatmap": rng.uniform(size=(2, 32, 32)).astype(np.float32),
            "pose_map": rng.normal(size=(2, 16, 16, 12)).astype(np.float32)}
    return lambda marks=None: trainer.train_iteration(cfg, step, host, "cpu", marks)


CS_TREE = [("forward", None, 0), ("encoder", "forward", 2), ("trunk", "forward", 4),
           ("heads.heatmap", "forward", 10), ("heads.pose", "forward", 10),
           ("loss", "forward", 0), ("backward", None, 0), ("optimizer", None, 0)]


def test_tiny_centersnap_step_records_the_span_tree():
    """One training iteration: the encoder, the trunk, each head and the
    loss inside forward, then backward and optimizer. Host syncs: the
    batch's 4 pageable uploads (on the request, before any span), the
    normalisation constants, the trunk's RoPE tables and each head's
    position-embedding grids."""
    step = _centersnap_iteration()
    with pprof.recording() as rec:
        step()
    (req,) = rec.resolve()
    assert _spans(req) == CS_TREE
    assert req.counts == {"host_syncs": 4 + sum(n for _, _, n in CS_TREE),
                          "norm_fused": 2}


def test_tiny_centersnap_marks_are_the_parents():
    """train_iteration's marks: the start event, then the step's top-level
    spans' end events; the request lands in `marked`."""
    step = _centersnap_iteration()
    marks = []
    step(marks)
    assert [n for n, _ in marks] == ["start", "forward", "backward", "optimizer"]
    req = pprof.marked.requests[-1]
    top = [s for s in req.spans if s.parent is None]
    assert marks[0][1] is top[0].start
    assert [ev for _, ev in marks[1:]] == [s.end for s in top]
    assert _spans(req) == CS_TREE and req.counts["host_syncs"] == 30


def test_tracing_off_centersnap_step_makes_no_event(monkeypatch):
    """With tracing off, a training iteration creates no CUDA event, enters
    no record_function and records nothing."""
    step = _centersnap_iteration()
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append("event"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append("record_function"))
    before = pprof.marked.n_requests
    step()
    assert made == [] and pprof.marked.n_requests == before and pprof._recorder is None


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
