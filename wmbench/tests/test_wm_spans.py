"""wmbench.spans.summarize on a hand-made Chrome trace (nested program
spans as user annotations, runtime launches and device work linked by
correlation id), and the readers of the program's own spans and counters
(wmbench.program) on requests recorded through `marks`, as a traced run's
window records them."""

import sys
from types import ModuleType, SimpleNamespace

import pytest

from wmbench import program, spans, trace

US = 1e-6


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "pid": 1, "args": args}


def _launch(corr, host_ts, kernel, dev_ts, dur, op, ext, cat="kernel"):
    """A runtime call, its device event and the operator that made it."""
    return [_x("cpu_op", op, host_ts - 2, 10, **{"External id": ext}),
            _x("cuda_runtime", "cudaLaunchKernel", host_ts, 5, correlation=corr),
            _x(cat, kernel, dev_ts, dur, tid=7, correlation=corr, **{"External id": ext})]


EVENTS = ([_x("user_annotation", trace.SPAN, 0, 1000),
           _x("user_annotation", "gs_render", 70, 780),
           _x("user_annotation", "render.bin", 100, 300),
           _x("user_annotation", "render.blend", 500, 190),
           _x("gpu_user_annotation", "render.bin", 200, 250, tid=7)]
          + _launch(15, 30, "Memcpy HtoD", 40, 20, "aten::copy_", 105, cat="gpu_memcpy")
          + _launch(11, 120, "radix_sort_kernel", 200, 100, "aten::sort", 101)
          + _launch(12, 150, "mul_kernel", 400, 50, "aten::mul", 102)
          + _launch(13, 520, "raster_flat_kernel", 600, 100, "aten::copy_", 103)
          + _launch(14, 900, "add_kernel", 950, 50, "aten::add", 104)
          + _launch(16, 1100, "Memset", 1200, 100, "aten::fill_", 106, cat="gpu_memset"))


def test_gaps_are_named_by_the_innermost_span():
    st = spans.summarize(EVENTS, 2e-3)
    assert dict((k, pytest.approx(v)) for k, v in st.idle_gaps) == {
        "wmbench.request > aten::sort": 140 * US,
        "render.bin > aten::mul": 100 * US,
        "gs_render > aten::copy_": 150 * US,
        "gs_render > aten::add": 250 * US,
        "between requests > aten::fill_": 200 * US}


def test_busy_and_gap_totals_are_trace_summarize_s():
    st, base = spans.summarize(EVENTS, 2e-3), trace.summarize(EVENTS, 2e-3)
    assert st.base == base
    assert sum(v for _, v in st.idle_gaps) == pytest.approx(sum(v for _, v in base.idle_gaps))
    assert sum(s["idle_s"] for s in st.spans.values()) == pytest.approx(840 * US)
    assert base.busy_s == pytest.approx(420 * US) and base.launches == 4


def test_launches_are_attributed_per_span():
    st = spans.summarize(EVENTS, 2e-3).spans
    assert {k: v["launches"] for k, v in st.items()} == {
        "render.bin": 2, "render.blend": 1, "wmbench.request": 1, "gs_render": 0,
        "between requests": 0}
    assert st["render.bin"]["busy_s"] == pytest.approx(150 * US)
    assert st["render.bin"]["idle_s"] == pytest.approx(100 * US)
    assert st["gs_render"]["idle_s"] == pytest.approx(400 * US)
    assert [k for k, _ in st["render.bin"]["top"]] == ["radix_sort_kernel", "mul_kernel"]
    assert st["wmbench.request"]["busy_s"] == pytest.approx(70 * US)   # add + the copy
    assert st["between requests"]["busy_s"] == pytest.approx(100 * US)


def test_innermost_of_nested_intervals():
    iv = [(0, 10, "a"), (2, 8, "b"), (3, 4, "c"), (5, 7, "d"), (12, 13, "e")]
    assert spans._innermost(iv, [1, 3.5, 4, 6, 9, 11, 12.5, 2]) == [
        "a", "c", "b", "d", "a", None, "e", "b"]


def test_program_readers_read_the_window():
    from hunyuanworld_mirror_tpu_torch.utils import profiling
    for i in range(3):
        marks = []
        with profiling.request(marks, start=True):
            with profiling.span("render_forward"):
                with profiling.span("render.bin"):
                    profiling.count("host_syncs", i)
                with profiling.span("render.bin"):
                    pass
            with profiling.span("optimizer"):
                pass
    run = SimpleNamespace(spans=[{}, {}])
    reqs = program.window(run)
    assert len(reqs) == 2 and reqs[-1] is profiling.marked.requests[-1]
    assert program.mean_count(run, "host_syncs") == 1.5
    got = program.mean_ms(run, "render.bin")
    want = sum(s.ms for r in reqs for s in r.spans if s.name == "render.bin") / 2
    assert got == pytest.approx(want) and got >= 0
    assert program.mean_ms(run, "loss") is None
    assert program.mean_ms(SimpleNamespace(spans=[]), "render.bin") is None


def test_program_readers_give_nothing_for_a_program_without_the_recorder(monkeypatch):
    """An older program (no `marked` recorder): every reader returns None."""
    old = ModuleType("hunyuanworld_mirror_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "hunyuanworld_mirror_tpu_torch.utils.profiling", old)
    import hunyuanworld_mirror_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiling", old)
    run = SimpleNamespace(spans=[{"heads": 1.0}])
    assert program.mean_ms(run, "heads.depth") is None
    assert program.mean_count(run, "host_syncs") is None
