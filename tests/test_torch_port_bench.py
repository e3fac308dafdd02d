"""The port's bench twin (hunyuanworld_mirror_tpu_torch/bench.py) on the CPU:
its FLOP counters and comm_report equal to the root bench.py's for the same
arguments (the root file is imported here, never by the port), model_flops
at the trunk's 7 special tokens above the root's by exactly the trunk's
extra tokens, the render's byte count against a hand count, the parent's
assembly with a stand-in row runner (each row's line printed as it ends,
the final line last, a budget skip, a failed row's exit code), a headline
row rehearsed at --device cpu --preset tiny --img 56, in this process and
as the parent spawns it, and a row without --device cpu on a machine with
no card exiting non-zero."""

import json

import pytest
import torch

import bench as root_bench
from hunyuanworld_mirror_tpu_torch import bench

SHAPES = [(1, 4, 518, 518), (1, 32, 518, 518), (2, 2, 266, 392), (1, 64, 518, 518),
          (1, 2, 56, 56)]
CPU_ROW = ["--device", "cpu", "--preset", "tiny", "--img", "56"]


@pytest.mark.parametrize("B,S,H,W", SHAPES)
def test_flop_counters_equal_root_bench(B, S, H, W):
    P = (H // 14) * (W // 14)
    assert bench.encoder_flops(B * S, P) == root_bench.encoder_flops(B * S, P)
    assert bench.encoder_flops(B * S, P, 64, 4) == root_bench.encoder_flops(B * S, P, 64, 4)
    assert bench.trunk_flops(B, S, P) == root_bench.trunk_flops(B, S, P)
    assert bench.trunk_flops(B, S, P, 384, 12, 7) == root_bench.trunk_flops(B, S, P, 384, 12, 7)
    assert bench.dpt_flops(B * S, H, W) == root_bench.dpt_flops(B * S, H, W)
    assert (bench.dpt_flops(S, H, W, 128, 32, (32, 48, 64, 64), 2)
            == root_bench.dpt_flops(S, H, W, 128, 32, (32, 48, 64, 64), 2))
    assert bench.model_flops(B, S, H, W) == root_bench.model_flops(B, S, H, W)
    assert bench.model_flops(B, S, H, W, 768, 128) == root_bench.model_flops(B, S, H, W, 768, 128)
    for shards in (1, 2, 8):
        assert bench.comm_report(S, H, W, shards) == root_bench.comm_report(S, H, W, shards)
    assert (bench.comm_report(S, H, W, 4, n_splats=1000, d_col=3)
            == root_bench.comm_report(S, H, W, 4, n_splats=1000, d_col=3))


@pytest.mark.parametrize("B,S,H,W", SHAPES)
def test_model_flops_counts_the_trunks_seven_special_tokens(B, S, H, W):
    P = (H // 14) * (W // 14)
    ours = bench.model_flops(B, S, H, W, n_special=7)
    ref = root_bench.model_flops(B, S, H, W)
    extra = root_bench.trunk_flops(B, S, P, n_special=7) - root_bench.trunk_flops(B, S, P)
    assert extra > 0
    assert ours["trunk"] - ref["trunk"] == extra
    assert ours["total"] - ref["total"] == pytest.approx(extra, rel=1e-9)
    assert (ours["encoder"], ours["heads"]) == (ref["encoder"], ref["heads"])


def test_render_work_model_hand_count():
    # S=2 cameras at 32 x 32: N0 = 2048 rows, N = 1024 compacted, 4 tiles;
    # each camera sorts its live rows, 10 and 20
    rw = bench.render_work_model(2, 32, 32, n_isects=[10, 20])
    prune = 2 * 2048 * 18 * 4                             # 294,912
    compact = 2 * 2048 * 13 * 4                           # 212,992
    isect = 2 * 10 * 8 * 4 + 2 * 20 * 8 * 4               # 1,920
    blend = (10 + 20) * 40 + 2 * 1024 * 5 * 4             # rows of 40 B; 5 f32 a pixel
    proj = 2 * 1024 * 17 * 4                              # 139,264
    assert rw["bytes_prune_compact"] == prune + compact
    assert rw["bytes_isect_sorts"] == isect
    assert rw["bytes_blend"] == pytest.approx(blend, rel=1e-12)
    assert rw["bytes_total"] == pytest.approx(691248, rel=1e-12)
    assert rw["n_splats_compact"] == 1024


def _runner(capsys, results, calls):
    """A stand-in row runner that checks every earlier row's line is
    already printed when the next row starts."""
    def run(row, timeout_s):
        printed = [ln for ln in capsys.readouterr().out.splitlines() if ln]
        calls.append((row, len(printed)))
        for ln in printed:
            calls.append(json.loads(ln))
        return dict(results.get(bench._key(row), {"ms": 1.0}))
    return run


HEAD = {"metric": bench.METRIC, "value": 10.5, "unit": bench.UNIT, "chip": "card",
        "power_limit_w": 700.0, "mfu": 0.05}


def test_parent_prints_each_row_as_it_ends(capsys):
    calls = []
    final, rc = bench.run_all(_runner(capsys, {"headline": HEAD}, calls), 1e6)
    tail = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln]
    starts = [c for c in calls if isinstance(c, tuple)]
    assert [r for r, _ in starts] == bench.ROWS
    # each row finds exactly the line of the row before it printed
    assert [n for _, n in starts] == [0] + [1] * (len(bench.ROWS) - 1)
    assert [c["row"] for c in calls if isinstance(c, dict)] == bench.ROWS[:-1]
    assert tail[-1] == final and rc == 0
    assert tail[-2] == {"row": bench.ROWS[-1], "ms": 1.0}
    assert final["value"] == 10.5 and final["chip"] == "card"
    assert final["long_seq"]["fwd"] == {"ms": 1.0}
    assert final["long_seq64"]["head_chunk"] == 2 and final["long_seq"]["head_chunk"] == 4
    assert final["comm"] == root_bench.comm_report(32, 518, 518, n_view_shards=8)
    assert final["skipped"] == [] and final["failed"] == []
    assert "vs_baseline" not in final and "baseline_note" not in final


def test_parent_lists_rows_past_the_budget_as_skipped(capsys):
    now = [0.0]

    def runner(row, timeout_s):
        assert timeout_s <= 300.0 - now[0]
        now[0] += 100.0
        return dict(HEAD) if row["stage"] == "headline" else {"ms": 1.0}

    final, rc = bench.run_all(runner, 300.0, clock=lambda: now[0])
    assert rc == 0
    ran = [k for k in ("fwd", "render", "ba") if "skipped" not in final["long_seq"][k]]
    assert ran == ["fwd", "render"]
    assert len(final["skipped"]) == 4 and final["skipped"][0].startswith("ba_s32: budget")
    assert final["long_seq64"]["fwd"]["skipped"].startswith("budget")


def test_parent_exits_nonzero_on_a_failed_row(capsys):
    calls = []
    results = {"headline": HEAD,
               "render_s64": {"failed": "OutOfMemoryError: CUDA out of memory"}}
    final, rc = bench.run_all(_runner(capsys, results, calls), 1e6)
    assert rc == 1
    assert final["failed"] == ["render_s64: OutOfMemoryError: CUDA out of memory"]
    assert final["long_seq64"]["render"] == results["render_s64"]
    assert final["long_seq64"]["ba"] == {"ms": 1.0}      # no retry, no other size


def _last_json(text):
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def test_headline_row_rehearsed_on_the_cpu(capsys):
    rc = bench.main(["--row", json.dumps({"stage": "headline"}), *CPU_ROW])
    row = _last_json(capsys.readouterr().out)
    assert rc == 0
    assert set(bench.HEADLINE_KEYS) <= set(row)
    assert row["chip"] == "cpu" and row["power_limit_w"] is None
    for k in ("value", "mfu", "sol", "achieved_tflops_per_s", "e2e_device_ms",
              "phases_ms", "peak_memory_gb"):
        assert row[k] is None, k
    assert row["e2e_wall_ms"] > 0 and row["n_forwards"] == bench.N_TIMED
    assert row["config"]["views"] == 4 and row["config"]["img"] == 56
    assert len(row["render_n_isects"]) == 4 and row["render_n_dropped"] >= 0
    assert row["exact_repeat_max_delta"] >= 0
    assert set(row["config"]) == {"preset", "batch", "views", "img", "param_dtype",
                                  "trunk_dtype", "head_dtype", "rasterizer_impl",
                                  "head_chunk", "seed", "device"}


def test_spawned_row_runs_in_its_own_process(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")    # the child's intra-op pool
    row = bench.spawn_row({"stage": "headline"}, CPU_ROW, timeout_s=600)
    assert "failed" not in row, row
    assert row["chip"] == "cpu" and row["mfu"] is None and row["e2e_wall_ms"] > 0


def test_row_without_cpu_flag_and_no_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--row", json.dumps({"stage": "headline"})])
    out = capsys.readouterr()
    assert rc != 0
    assert "no CUDA device" in _last_json(out.out)["failed"]
    assert "no CUDA device" in out.err
