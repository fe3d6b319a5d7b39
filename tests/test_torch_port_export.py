"""The serving export, TensorBoard scalars, profiling and `--compile-cache`
of the port, on CPU, against the JAX package where it has a counterpart.

The model is geodesic_bd at ResNet18 to layer2 (N0 128, N1 16, N2 8, K 8,
3 classes, 32 px), float64 on both sides with the JAX Trainer's weights
(random BN statistics) carried over by `from_jax_variables`. Tolerances:
the exported program equal to `make_inference_fn` (the same ops), and
within 1e-7 (POSE_TOL) of the JAX `export_inference` -> `load_inference` program at
two batch sizes, fixed, dynamic and with the fused resize; TensorBoard
(tag, step, value) triples equal to the JAX writer's.
"""

from __future__ import annotations

import glob
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multi_modal_regression_tpu.serving import export_inference as jax_export_inference
from multi_modal_regression_tpu.serving import load_inference as jax_load_inference
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.utils.metrics_writer import MetricsWriter as JaxMetricsWriter
from multi_modal_regression_tpu_torch import cli
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.ops import _build, preprocess, stem_pool
from multi_modal_regression_tpu_torch.serving import (
    export_inference,
    load_inference,
    make_inference_fn,
    save_inference,
)
from multi_modal_regression_tpu_torch.train.presets import get_config
from multi_modal_regression_tpu_torch.train.trainer import Trainer
from multi_modal_regression_tpu_torch.utils.metrics_writer import MetricsWriter, read_scalars
from multi_modal_regression_tpu_torch.utils.profiling import profile_trace, span

from test_torch_port_ops import one_torch_thread, randomize_batch_stats  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
    compute_dtype="float64",
)
# the two packages normalize the uint8 input in float32 in different op
# orders before the float64 model: measured 2.7e-8 on this CPU
POSE_TOL = 1e-7


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _requests(b: int, size: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed + b)
    return (rng.integers(0, 256, (b, size, size, 3), np.uint8),
            (np.arange(b) % 3).astype(np.int32))


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, its state with random BN statistics, the port trainer
    with the same weights), float64; stem_pool 'kernel' on the port (its
    plain version here), so the stem op is in the program too."""
    jax.config.update("jax_enable_x64", True)
    try:
        jt = JaxTrainer(jax_get_config("geodesic_bd", **SMALL, stem_pool=None,
                                       fused_conv_bn=None),
                        dictionary=_centers(), mesh=jax_make_mesh(jax.devices("cpu")[:1]))
        state = jax.device_get(jt.init_state())
        stats = randomize_batch_stats(state.batch_stats, np.random.default_rng(1))
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        state = state.replace(params=f64(state.params), batch_stats=f64(stats))
    finally:
        jax.config.update("jax_enable_x64", False)
    port = Trainer(get_config("geodesic_bd", **SMALL, stem_pool="kernel"),
                   dictionary=_centers(), device="cpu")
    port.model.load_state_dict(from_jax_variables(state.params, state.batch_stats))
    return jt, state, port


def _jax_served(jt, state, batch_size, image_size, requests):
    jax.config.update("jax_enable_x64", True)
    try:
        exported = jax_export_inference(jt, state, batch_size=batch_size, image_size=image_size)
        fn = jax_load_inference(exported.serialize())
        return [np.asarray(fn(x, lab)) for x, lab in requests]
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("batch_size,image_size", [
    ("dynamic", None), (8, None), (8, 48), ("dynamic", 48),
], ids=["dynamic", "fixed", "fixed_resize", "dynamic_resize"])
def test_export_matches_make_inference_fn_and_jax(pair, tmp_path, batch_size, image_size):
    """export_inference -> save -> load serves the rows make_inference_fn
    gives (bit-equal: the same ops) and the JAX export's within POSE_TOL, at
    batch sizes 8 and 5 (dynamic) or 8 (fixed); with image_size 48 the
    resize to 32 px is in both programs, and no normalize op runs. The
    program holds both kernels' ops, or only the stem's with the resize;
    labels out of range or of the wrong count raise on the host."""
    jt, state, port = pair
    size = image_size or 32
    sizes = (8, 5) if batch_size == "dynamic" else (8,)
    requests = [_requests(b, size) for b in sizes]
    ep = export_inference(port, batch_size, image_size=image_size)
    ops = {str(n.target) for n in ep.graph.nodes if "mmr" in str(n.target)}
    assert ops == ({"mmr.stem_pool_fwd.default"} if image_size else
                   {"mmr.normalize_u8.default", "mmr.stem_pool_fwd.default"})
    # conv1's output enters the stem op as traced: the program copies it nowhere
    stem = next(n for n in ep.graph.nodes if "stem_pool" in str(n.target))
    assert str(stem.args[0].target) == "aten.conv2d.default"
    save_inference(tmp_path / "p.pt2", ep)
    fn = load_inference(tmp_path / "p.pt2")
    assert fn.meta == {"num_classes": 3, "image_size": size, "batch_size": batch_size}
    ref = make_inference_fn(port.model, port.problem,
                            resize_to=32 if image_size else None)
    want = _jax_served(jt, state, batch_size, image_size, requests)
    for (x, lab), w in zip(requests, want):
        got = fn(x, lab)
        assert got.shape == (len(x), 3) and got.dtype == torch.float64
        assert torch.equal(got, ref(x, lab))
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=POSE_TOL)
    with pytest.raises(ValueError, match="labels must be in"):
        fn(*_requests(sizes[0], size)[:1], np.full(sizes[0], 3, np.int32))
    with pytest.raises(ValueError, match="images but labels"):
        fn(requests[0][0], requests[0][1][:-1])


def test_export_reloads_in_a_process_that_builds_no_model(pair, tmp_path):
    """A program saved here serves in a fresh interpreter that imports only
    serving.load_inference (which imports ops/ to register the kernels'
    ops): no model module is imported there, and its poses equal this
    process's."""
    _, _, port = pair
    save_inference(tmp_path / "p.pt2", export_inference(port, "dynamic"))
    x, lab = _requests(6)
    np.savez(tmp_path / "req.npz", x=x, lab=lab)
    code = (
        "import sys, numpy as np, torch\n"
        "from multi_modal_regression_tpu_torch.serving import load_inference\n"
        f"fn = load_inference({str(tmp_path / 'p.pt2')!r})\n"
        f"z = np.load({str(tmp_path / 'req.npz')!r})\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, fn(z['x'], z['lab']).numpy())\n"
        "bad = [m for m in sys.modules if m.startswith('multi_modal_regression_tpu_torch.')\n"
        "       and m.split('.')[1] in ('models', 'train', 'losses', 'parallel')]\n"
        "assert not bad, bad\n"
        "assert 'multi_modal_regression_tpu' not in sys.modules and 'jax' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    want = make_inference_fn(port.model, port.problem)(x, lab)
    assert np.array_equal(np.load(tmp_path / "out.npy"), want.numpy())


def test_ops_keep_their_counters_and_plain_cpu_versions():
    """The custom ops take their plain versions on CPU tensors and count
    nothing there; the wrappers check their inputs before the op."""
    x = torch.from_numpy(_requests(2)[0])
    before = (preprocess.launches, stem_pool.launches)
    assert torch.equal(torch.ops.mmr.normalize_u8(x, torch.float32),
                       preprocess.normalize_images_cuda(x))
    y = torch.randn(2, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    a, b = torch.rand(8) + 0.5, torch.randn(8)
    assert torch.equal(torch.ops.mmr.stem_pool_fwd(y, a, b), stem_pool._composite(y, a, b))
    assert (preprocess.launches, stem_pool.launches) == before
    with pytest.raises(ValueError, match="uint8"):
        preprocess.normalize_images_cuda(x.float())


# --- TensorBoard, profiling, the compile cache -----------------------------------


RECORDS = [(1, {"loss": 2.5, "lc": 1.25, "alpha": 0.25}), (50, {"train_loss": 1.125}),
           (100, {"med_err": 33.0, "val_loss": 33.0}), (7, {"x": -1e-3, "y": 3e38})]


def _tf_triples(logdir: Path) -> list[tuple]:
    import tensorflow as tf

    out = []
    for f in sorted(glob.glob(str(logdir / "events*"))):
        for e in tf.compat.v1.train.summary_iterator(f):
            for v in e.summary.value:
                val = (v.simple_value if v.WhichOneof("value") == "simple_value"
                       else float(tf.make_ndarray(v.tensor)))
                out.append((v.tag, e.step, val))
    return out


def test_tensorboard_scalars_match_the_jax_writer(tmp_path):
    """MetricsWriter(tensorboard=True) writes <workdir>/tb event files that
    tensorflow's summary_iterator reads back as the same (tag, step, value)
    triples as the JAX package's writer gives for the same records (each
    value a float32); read_scalars, the port's own reader, agrees; the
    jsonl records are as before."""
    port, ref = MetricsWriter(tmp_path / "p", tensorboard=True), JaxMetricsWriter(
        tmp_path / "j", tensorboard=True)
    for step, rec in RECORDS:
        port.write(step, rec)
        ref.write(step, rec)
    ref.close()
    got = _tf_triples(tmp_path / "p" / "tb")
    assert got == _tf_triples(tmp_path / "j" / "tb")
    assert len(got) == sum(len(r) for _, r in RECORDS)
    (path,) = (tmp_path / "p" / "tb").glob("events.out.tfevents.*")
    assert read_scalars(path) == got
    assert (tmp_path / "p" / "metrics.jsonl").read_text() == (
        tmp_path / "j" / "metrics.jsonl").read_text()


def test_trainer_writes_tensorboard(tmp_path):
    """A Trainer with cfg.tensorboard logs its records to the event file too."""
    cfg = get_config("geodesic_bd", **{**SMALL, "compute_dtype": "float32"}, tensorboard=True)
    t = Trainer(cfg, dictionary=_centers(), workdir=tmp_path, device="cpu")
    t._log({"step": 3, "loss": 1.5, "med_err": 20.0})
    (path,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    assert read_scalars(path) == [("loss", 3, 1.5), ("med_err", 3, 20.0)]


def test_profile_trace_writes_the_kernels_and_the_step_spans(pair, tmp_path):
    """profile_trace over 3 train steps writes a Chrome trace naming the
    kernels' ops and, 3 times each, the step's forward, backward and
    optimizer spans, the kernels' ops inside the forward; enabled=False
    writes none, and a span there is the shared no-op."""
    import json

    _, _, port = pair
    x, lab = _requests(6)
    batch = {"xdata": torch.from_numpy(x), "label": torch.from_numpy(lab),
             "euler": torch.zeros(6, 3, dtype=torch.float32),
             "is_real": torch.arange(6) < 3}
    step = port.train_step_fn("main", dual_stream=True)
    state = port.init_state()
    with profile_trace(tmp_path / "prof") as prof:
        for _ in range(3):
            state, _ = step(state, batch)
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    names = [e["name"] for e in events]
    assert {"mmr::normalize_u8", "mmr::stem_pool_fwd"} <= set(names)
    for layer in ("forward", "backward", "optimizer"):
        assert names.count(f"mmr.train.{layer}") == 3
    fwd = [e for e in events if e["name"] == "mmr.train.forward"]
    for e in events:
        if e["name"] in ("mmr::normalize_u8", "mmr::stem_pool_fwd"):
            assert any(f["ts"] <= e["ts"] and e["ts"] + e["dur"] <= f["ts"] + f["dur"]
                       for f in fwd), e
    assert prof is not None
    with profile_trace(tmp_path / "off", enabled=False) as off:
        assert off is None
        assert span("mmr.train.forward") is span("mmr.train.step", 1)
    assert not (tmp_path / "off").exists()


@pytest.mark.parametrize("choice", ["dir", "off", "unwritable"])
def test_compile_cache_routes_the_build_dir(tmp_path, monkeypatch, capsys, choice):
    """--compile-cache DIR makes DIR the kernel library's directory, `off` a
    fresh temporary one; a DIR that cannot be made keeps the default and
    says so. The library's path follows the directory."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    default = _build.BUILD_DIR
    blocker = tmp_path / "file"
    blocker.write_text("")
    arg = {"dir": str(tmp_path / "cache"), "off": "off",
           "unwritable": str(blocker / "sub")}[choice]
    args = cli.build_parser().parse_args(
        ["dictionary", "--data-root", "x", "--out", "y", "--compile-cache", arg])
    cli._setup_compile_cache(args)
    if choice == "dir":
        assert _build.BUILD_DIR == tmp_path / "cache" and (tmp_path / "cache").is_dir()
    elif choice == "off":
        assert _build.BUILD_DIR != default and _build.BUILD_DIR.name.startswith("mmr_kernels_")
        assert _build.BUILD_DIR.is_dir()
        _build.BUILD_DIR.rmdir()
    else:
        assert _build.BUILD_DIR == default
        assert "compile cache disabled" in capsys.readouterr().out
    assert _build.library_path().parent == _build.BUILD_DIR
