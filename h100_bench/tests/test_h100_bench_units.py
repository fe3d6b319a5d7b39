"""The benchmark's arithmetic and its boundaries, with no port and no card:
FLOP counts against hand counts, the roofline, idle and per-unit readers on
synthetic traces, and the imports of every file under h100_bench/."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

import torch

from h100_bench import compare, core, inputs
from h100_bench.configs import resnet_bin_delta as fam
from h100_bench.metrics import _kernels, _shared
from h100_bench.peaks import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS
from h100_bench.trace import Trace

BENCH = Path(core.BENCH)
GEO = core.load_json(BENCH / "configs" / "geodesic_bd.json")
MULTI = core.load_json(BENCH / "configs" / "geodesic_bd_multires.json")


def bottleneck(cin, w, stride, h):
    """FLOPs of one bottleneck block on an h x h input, by hand."""
    ho = h // stride
    f = 2 * cin * w * h * h          # 1x1 reduce at the input's size
    f += 2 * w * w * 9 * ho * ho     # 3x3, strided
    f += 2 * w * 4 * w * ho * ho     # 1x1 expand
    if stride != 1 or cin != 4 * w:
        f += 2 * cin * 4 * w * ho * ho  # 1x1 downsample
    return f


def test_trunk_flops_by_hand():
    cfg = dict(GEO, feature_layer="layer2")
    conv1 = 2 * 64 * 3 * 7 * 7 * 112 * 112
    want = conv1 + bottleneck(64, 64, 1, 56) + 2 * bottleneck(256, 64, 1, 56)
    want += bottleneck(256, 128, 2, 56) + 3 * bottleneck(512, 128, 1, 28)
    assert fam.trunk_flops(cfg) == (want, conv1)


def test_resnet50_flops_match_the_published_count():
    # ResNet50 to layer4 at 224 px: 4.09 G multiply-adds with its 2048 x 1000
    # classifier (2.05 M), which the trunk does not have
    trunk, _ = fam.trunk_flops(GEO)
    assert abs(trunk / 2 + 2048 * 1000 - 4.09e9) / 4.09e9 < 0.005


def test_head_flops_by_hand():
    assert fam.head_flops(GEO) == 2 * (2048 * 1000 + 1000 * 500 + 500 * 200) \
        + 2 * (2048 * 1000 + 1000 * 500 + 500 * 3)
    # multires: the row's class's 200 delta heads of 2048 -> 100 -> 3
    assert fam.head_flops(MULTI) == 2 * (2048 * 1000 + 1000 * 500 + 500 * 200) \
        + 200 * 2 * (2048 * 100 + 100 * 3)


def test_train_flops_are_three_forwards_less_the_first_input_gradient():
    trunk, conv1 = fam.trunk_flops(GEO)
    fwd = trunk + fam.head_flops(GEO)
    assert fam.flops(GEO, 192, train=True) == 192 * (3 * fwd - conv1)
    assert fam.flops(GEO, 96, train=False) == 96 * fwd
    # about 4.7 TFLOP a 192-image step
    assert 4.5e12 < fam.flops(GEO, 192, train=True) < 4.9e12


def test_kernel_calls_of_a_step_and_a_request():
    step = fam.kernel_calls(GEO, 192, 2, train=True)
    assert [k for k, _ in step] == ["normalize", "stem_fwd", "stem_fwd", "stem_bwd", "stem_bwd"]
    assert step[0][1] == dict(B=192, H=224, W=224, itemsize=2)
    assert step[1][1] == dict(B=96, C=64, H=112, W=112, itemsize=2)
    req = fam.kernel_calls(GEO, 96, 1, train=False)
    assert [k for k, _ in req] == ["normalize", "stem_fwd"]


def test_kernel_work_matches_the_kernel_table():
    # PERF.md's kernel table: #1 at 96 images 43,352,064 B; #2 at 48
    # images 0.0288 ms; #8 at 48 images 173,408,256 B and 539,492,352 op
    assert _kernels.work("normalize", dict(B=96, H=224, W=224, itemsize=2))[0] == 43352064
    stem = dict(B=48, C=64, H=112, W=112, itemsize=2)
    nbytes, ops = _kernels.work("stem_fwd", stem)
    assert round(max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS) * 1e3, 4) == 0.0288
    assert _kernels.work("stem_bwd", stem) == (173408256, 539492352)


def run_with(trace, **kw):
    base = dict(kind="train", setup_s=1.0, window_s=1.0, attempted=1, failed=0, images=1,
                latencies_s=[], memory_peak_bytes=0, numbers={}, flops_per_unit=0.0,
                kernel_calls=[], trace=trace)
    return core.Run(**(base | kw))


def synthetic_trace():
    device = [("void normalize_u8_kernel<bf16>(...)", 0.0, 10.0),
              ("void stem_fwd_kernel<bf16, 8>(...)", 5.0, 20.0),
              ("Memcpy HtoD (Pageable -> Device)", 30.0, 40.0),
              ("void stem_bwd_kernel<bf16, 8>(...)", 40.0, 60.0),
              ("stem_dab_kernel(float const*, float*, int, int)", 70.0, 80.0)]
    host = [("train_step", 0.0, 100.0), ("aten::copy_", 21.0, 35.0),
            ("cudaMemcpyAsync", 22.0, 29.0), ("cudaStreamSynchronize", 61.0, 75.0)]
    return Trace(device, host, {"bench.trunk_fwd": 400.0}, units=2)


def test_busy_window_and_idle_share():
    tr = synthetic_trace()
    assert tr.busy_window_us() == (60.0, 80.0)  # [0, 20] + [30, 60] + [70, 80]
    assert tr.gaps_us() == [(20.0, 30.0), (60.0, 70.0)]
    assert _shared.idle_pct(run_with(tr)) == pytest.approx(25.0)


def test_idle_gaps_by_what_the_host_was_doing():
    # the gap 20-30 (middle 25) lies under train_step, aten::copy_ and
    # cudaMemcpyAsync: the innermost is the copy call; 60-70 under the sync
    gaps = dict(synthetic_trace().idle_gaps())
    assert gaps == pytest.approx({"cudaMemcpyAsync": 10e-6, "cudaStreamSynchronize": 10e-6})


def test_device_ops_by_total_time():
    ops = synthetic_trace().device_ops()
    assert ops[0] == ["void stem_bwd_kernel<bf16, 8>(...)", pytest.approx(20e-6)]
    assert len(ops) == 5


def test_roofline_share_of_the_kernels():
    calls = [("normalize", dict(B=4, H=8, W=8, itemsize=2)),
             ("stem_fwd", dict(B=4, C=64, H=8, W=8, itemsize=2)),
             ("stem_bwd", dict(B=4, C=64, H=8, W=8, itemsize=2))]
    tr = synthetic_trace()
    bound = sum(max(b / PEAK_BYTES, o / PEAK_F32_FLOPS)
                for b, o in (_kernels.work(k, d) for k, d in calls))
    # 2 units; the kernels' device time: 10 + 15 + 20 + 10 us (the copy is not one)
    want = 100 * bound * 2 / 55e-6
    assert _kernels.roofline_pct(run_with(tr, kernel_calls=calls)) == pytest.approx(want)
    # a serving run has no #8: its time is left out with its bound
    serve = calls[:2]
    want = 100 * sum(max(b / PEAK_BYTES, o / PEAK_F32_FLOPS)
                     for b, o in (_kernels.work(k, d) for k, d in serve)) * 2 / 25e-6
    assert _kernels.roofline_pct(run_with(tr, kernel_calls=serve)) == pytest.approx(want)


def test_mfu_launches_and_ranges_per_unit():
    tr = synthetic_trace()
    run = run_with(tr, flops_per_unit=1e9, host_trace=tr)
    assert _shared.mfu_pct(run) == pytest.approx(100 * 2e9 / 80e-6 / PEAK_BF16_FLOPS)
    assert _shared.launches_per_unit(run) == 2.5
    assert _shared.range_ms_per_unit(run, "bench.trunk_fwd") == pytest.approx(0.2)
    assert _shared.range_ms_per_unit(run, "bench.heads_fwd") is None


def test_readers_find_nothing_without_a_trace():
    run = run_with(None)
    for name in ("device_idle_pct.train", "mfu_pct.infer", "kernel_roofline_pct.train",
                 "launches_per_step.train", "adam_device_ms.train",
                 "trunk_fwd_device_ms.infer", "heads_fwd_device_ms.train"):
        reader = core.load_module(BENCH / "metrics" / f"{name}.py", f"m_{name}")
        assert reader.read(run) is None
    empty = Trace([], [], {}, units=0)
    assert _kernels.roofline_pct(run_with(empty)) is None


def test_e2e_readers():
    run = run_with(None, images=192 * 10, window_s=2.0)
    read = {n: core.load_module(BENCH / "metrics" / f"{n}.py", f"m_{n}").read
            for n in ("train_img_s", "infer_img_s", "infer_p95_ms", "setup_s")}
    assert read["train_img_s"](run) == 960.0
    assert read["infer_img_s"](run) is None
    serve = run_with(None, kind="serve", latencies_s=[0.01 * i for i in range(1, 101)])
    assert read["infer_p95_ms"](serve) == pytest.approx(950.5)
    assert read["setup_s"](run) == 1.0


def _grads(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {f"leaf{i}": torch.randn(50 + 10 * i, generator=g) for i in range(6)}


def _side(grad: dict, change: dict) -> dict:
    return {"grad": grad, "change": change, "loss": [1.0], "lc": [1.0], "margins": [1.0]}


def test_train_numbers_tell_a_gradient_of_the_right_size_from_the_right_one():
    ref = _side(_grads(1), {f"leaf{i}": 1.0 for i in range(6)})
    sound = _side({k: v * (1 + 1e-4) for k, v in ref["grad"].items()}, dict(ref["change"]))
    wrong = _side({k: v.flip(0) for k, v in ref["grad"].items()}, dict(ref["change"]))
    ok, bad = compare.train_readings(sound, ref)[0], compare.train_readings(wrong, ref)[0]
    assert ok["grad_gap"] == pytest.approx(1e-4, rel=1e-3)
    assert ok["grad_diff_gap"] == pytest.approx(1e-4, rel=1e-3)
    assert bad["grad_gap"] == pytest.approx(0.0, abs=1e-6)  # the same norms
    assert bad["grad_diff_gap"] > 0.5 and bad["grad_diff_median"] > 0.5
    assert 0.5e-4 < ok["grad_diff_median"] <= ok["grad_diff_gap"]
    assert ok["change_gap"] == bad["change_gap"] == 0.0


def test_train_numbers_leave_out_leaves_nought_to_rounding_and_count_missing_ones():
    ref = _side(_grads(2), {f"leaf{i}": 1.0 for i in range(6)})
    ref["grad"]["bias_under_softmax"] = torch.full((4,), 1e-9)
    ref["change"]["bias_under_softmax"] = 0.0
    prog = _side({k: v.clone() for k, v in ref["grad"].items()}, ref["change"])
    prog["grad"]["bias_under_softmax"] = torch.ones(4)  # rounding: not compared
    assert compare.train_readings(prog, ref)[0]["grad_diff_gap"] == 0.0
    del prog["grad"]["leaf3"]  # a leaf the program left unmoved
    nums = compare.train_readings(prog, ref)[0]
    assert nums["grad_gap"] > 0.5 and nums["grad_diff_gap"] > 0.5


def test_raised_bins_put_one_bin_first_by_the_margin():
    W = {"bin_models.fc3_bias": torch.zeros(4, 10), "bin_models.bn1.bias": torch.zeros(5)}
    inputs.raise_bins(W, 2**31 + 5, 6.0, "cpu")
    top2 = torch.topk(W["bin_models.fc3_bias"], 2, dim=-1).values
    assert torch.equal(top2[:, 0] - top2[:, 1], torch.full((4,), 6.0))
    assert not W["bin_models.bn1.bias"].any()


def test_every_metric_has_a_reader_and_every_cell_its_files(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for w in spec["workloads"]:
        cell, config, traffic, limits = core.cell_files(spec, w["name"])
        assert limits and traffic["driver"] in ("train", "serve")
        assert config["family"] == "resnet_bin_delta"


def test_each_cell_reports_setup_another_e2e_and_a_per_layer_metric(spec):
    for w in spec["workloads"]:
        e2e = [m["name"] for m in core.cell_metrics(spec, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(spec, w["name"], True)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


PORT_TESTS = {"test_h100_bench_port.py"}  # the tests that compare with the port


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & set(core.FORBIDDEN)
        assert not found, f"{path.relative_to(BENCH)} imports {found}"


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "math", "torch", "h100_bench"}, path
        text = path.read_text()
        assert "multi_modal_regression_tpu" not in text.replace(
            "multi-modal-regression", ""), path


def test_only_the_drivers_the_families_and_the_port_tests_import_the_port():
    for path in BENCH.rglob("*.py"):
        if "multi_modal_regression_tpu_torch" in _imports(path) and path.name not in PORT_TESTS:
            assert path.parent.name in ("drivers", "configs"), path
