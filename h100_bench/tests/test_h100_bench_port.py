"""The harness against the port at a tiny size on the CPU: the reference's
forward against the port's from the same weights, a sound run that comes
out correct with the result's keys, and runs with the timed path broken
underneath that come out not correct (the look for a card is skipped:
`core.run_cell` is called with the CPU)."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from h100_bench import core, inputs
from h100_bench.drivers import common
from h100_bench.reference import bin_delta as ref
from multi_modal_regression_tpu_torch.data.loader import normalize_images
from multi_modal_regression_tpu_torch.train import presets
from multi_modal_regression_tpu_torch.train import trainer as trainer_module

SEED = 2**31 + 11  # past 32 signed bits, as a run's seed may be


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def run(spec, workload, seconds=0.3):
    return core.run_cell(spec, workload, SEED, seconds, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["geodesic_bd", "geodesic_bd_multires"])
@pytest.mark.parametrize("train", [True, False])
def test_reference_forward_matches_the_port(tiny_spec, name, train):
    cfg_file = next(c["file"] for c in tiny_spec["configs"] if c["name"] == name)
    c = core.load_json(cfg_file)
    from h100_bench.configs import resnet_bin_delta as fam

    model = presets.build_model(fam.port_config(c, {}, SEED), "cpu", param_dtype=torch.float32)
    W = inputs.draw_weights(ref.param_specs(c), SEED, "cpu", eval_stats=True)
    common.load_weights(model, W)
    g = inputs.generator(SEED, "requests", "cpu")
    x = inputs.draw_images(g, 6, c["image_size"], "cpu")
    labels = torch.tensor([0, 1, 2, 2, 1, 0])
    model.train(train)
    with torch.no_grad():
        scores, delta = model(normalize_images(x, torch.float32), labels)
        want_s, want_d = ref.forward(W, c, x, labels, train)
    if want_d.ndim == 3:  # multires: the port returns the argmax bin's delta
        want_d = want_d[torch.arange(6), torch.argmax(want_s, dim=-1)]
    torch.testing.assert_close(scores, want_s, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(delta, want_d, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("workload", ["geodesic_bd.train", "geodesic_bd_multires.infer"])
def test_sound_run_is_correct_and_prints_the_contract_keys(tiny_spec, workload):
    r = run(tiny_spec, workload)
    assert r["correct"], r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and 0 <= c["value"] <= c["limit"]
    json.dumps(r)


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tiny_spec, monkeypatch):
    monkeypatch.setattr(presets.Adam, "step", lambda self, closure=None: None)
    r = run(tiny_spec, "geodesic_bd.train")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def _stem_bwd_fault(alter):
    """#8, the stem's backward, with its input gradient altered."""
    from multi_modal_regression_tpu_torch.ops import stem_pool

    bwd = stem_pool.stem_pool_bwd

    def broken(g, y, a, b):
        dy, da, db = bwd(g, y, a, b)
        return alter(dy), da, db

    return broken


@pytest.mark.parametrize("alter", [torch.zeros_like, lambda dy: dy.flip(-1)],
                         ids=["zeroed", "mirrored"])
def test_a_wrong_stem_backward_is_not_correct(tiny_spec, monkeypatch, alter):
    from multi_modal_regression_tpu_torch.ops import stem_pool

    monkeypatch.setattr(stem_pool, "stem_pool_bwd", _stem_bwd_fault(alter))
    r = run(tiny_spec, "geodesic_bd.train")
    assert not r["correct"], r["checks"]
    assert r["checks"]["grad_diff_gap"]["value"] > r["checks"]["grad_diff_gap"]["limit"]


def _half(losses):
    def half(out, tg):
        n = tg["class_label"].shape[0] // 2
        return losses(tuple(o[:n] for o in out), {k: v[:n] for k, v in tg.items()})
    return half


def test_half_the_batch_left_out_is_not_correct(tiny_spec, monkeypatch):
    make = trainer_module.make_train_step

    def broken(model, problem, *a, **kw):
        p = dataclasses.replace(problem, main_losses=_half(problem.main_losses))
        return make(model, p, *a, **kw)

    monkeypatch.setattr(trainer_module, "make_train_step", broken)
    r = run(tiny_spec, "geodesic_bd_multires.train")
    assert not r["correct"], r["checks"]


def _serving(monkeypatch, alter):
    from multi_modal_regression_tpu_torch import serving

    make = serving.make_inference_fn

    def broken(*a, **kw):
        fn = make(*a, **kw)
        return lambda images, labels: alter(fn, images, labels)

    monkeypatch.setattr(serving, "make_inference_fn", broken)


def test_an_answer_altered_where_it_is_produced_is_not_correct(tiny_spec, monkeypatch):
    def alter(fn, images, labels):
        poses = fn(images, labels).clone()
        poses[0, 0] += 0.5
        return poses

    _serving(monkeypatch, alter)
    r = run(tiny_spec, "geodesic_bd.infer")
    assert not r["correct"] and r["checks"]["pose_gap"]["value"] > 0.4


def test_half_a_request_left_out_is_not_correct(tiny_spec, monkeypatch):
    def alter(fn, images, labels):
        n = len(labels) // 2
        poses = fn(images[:n], labels[:n])
        return torch.cat([poses, poses.new_zeros(len(labels) - n, poses.shape[1])])

    _serving(monkeypatch, alter)
    r = run(tiny_spec, "geodesic_bd_multires.infer")
    assert not r["correct"]


def test_a_run_loads_no_jax_and_no_jax_package(tiny_spec, tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(tiny_spec))
    code = (
        "import json, sys, time; sys.path.insert(0, sys.argv[1]); import torch; "
        "torch.set_num_threads(2); from h100_bench import core; "
        "spec = json.load(open(sys.argv[2])); "
        "r = core.run_cell(spec, 'geodesic_bd.infer', 7, 0.2, False, 'cpu', time.perf_counter()); "
        "print(json.dumps(core.loaded_forbidden()))"
    )
    out = subprocess.run([sys.executable, "-c", code, str(core.ROOT), str(path)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
