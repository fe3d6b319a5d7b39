"""The train step replayed as CUDA graphs (train/steps.GraphedTrainStep)
and the Trainer's pinned staging of batches (train/trainer._Staging).

On the CPU: which configurations run the eager step (`graph_blocker`), that
make_train_step gives the eager step there, and the wrapper's choice of
eager step, capture or replay by batch layout and state (capture and
replay stood in for). Marked `cuda`, skipping where torch.cuda.is_available()
is False (decided in the fixture): a small Trainer's graphed steps equal its
eager steps bit for bit over several steps, an epoch-rate change and a
partial batch, and a capture changes no state. On the card:

    python -m pytest --noconftest tests/test_torch_port_graph.py -q
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import multi_modal_regression_tpu_torch.train.steps as steps
from multi_modal_regression_tpu_torch.parallel.mesh import Mesh
from multi_modal_regression_tpu_torch.train.presets import Adam, build_model, get_config
from multi_modal_regression_tpu_torch.train.problems import make_problem
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.trainer import Trainer

SMALL = dict(N1=16, N2=8, N3=4, image_size=32, items_per_batch=2, num_classes=3, dict_size=8,
             feature_network="resnet18", feature_layer="layer2", N0=128)
CENTERS = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)


def _batches(seed: int, n: int, steps_: int, classes: int = 3, size: int = 32):
    rng = np.random.default_rng(seed)
    return [{"xdata": rng.integers(0, 256, (n, size, size, 3), np.uint8),
             "euler": rng.uniform(-60, 60, (n, 3)).astype(np.float32),
             "label": (np.arange(n) % classes).astype(np.int32)} for _ in range(steps_)]


# --- which configurations fall back (CPU) ------------------------------------------


class _Drawing(torch.nn.Module):
    dropout_rng = None


class _Remat(torch.nn.Module):
    remat = "block"


@pytest.mark.parametrize("case,reason", [
    ("graphable", None),
    ("cpu", "a cpu device"),
    ("ranks", "several ranks"),
    ("remat", "remat mode"),
    ("vgg", "VGG trunk"),
    ("resize", "device_resize_from"),
    ("sgd", "SGD cannot capture"),
    ("gmm", "probabilistic problem"),
])
def test_graph_blocker_names_each_fallback(case, reason):
    """graph_blocker is None for a one-process step of a CUDA device with
    Adam and no remat, dropout, resize or GMM targets, and names the reason
    otherwise: the CPU, a mesh of two ranks, a remat mode, a module that
    draws dropout (the VGG trunks), device_resize_from, an optimizer with no
    capture_update, the GMM posterior's problems (their Cholesky checks its
    result on the host)."""
    p = torch.nn.Parameter(torch.zeros(3))
    device, mesh, modules = torch.device("cuda"), Mesh(), [torch.nn.Linear(2, 2)]
    opt, resize = Adam([p], lr=1e-3), None
    problem = make_problem("geodesic", CENTERS, "cpu")
    if case == "cpu":
        device = torch.device("cpu")
    elif case == "ranks":
        mesh = Mesh(rank=0, world=2, n_data=2)
    elif case == "remat":
        modules.append(_Remat())
    elif case == "vgg":
        modules.append(_Drawing())
    elif case == "resize":
        resize = 32
    elif case == "sgd":
        opt = torch.optim.SGD([p], lr=1.0)
    elif case == "gmm":
        problem = make_problem("probabilistic", CENTERS, "cpu", gmm_means=CENTERS,
                               gmm_covariances=np.tile(np.eye(3, dtype=np.float32), (8, 1, 1)),
                               gmm_weights=np.full(8, 1 / 8, np.float32))
    got = steps.graph_blocker(device, mesh, modules, opt, resize, problem)
    assert got is None if reason is None else reason in got


def test_cpu_trainer_runs_the_eager_step_and_its_own_copies():
    """On the CPU the Trainer's step is make_train_step's eager function (no
    GraphedTrainStep) and `_to_device` stages nothing: the tensors share
    the host batch's memory, as before."""
    cfg = get_config("geodesic_bd", **SMALL, compute_dtype="float32")
    t = Trainer(cfg, dictionary=CENTERS, device="cpu")
    step = t.train_step_fn("main", dual_stream=True)
    assert not isinstance(step, steps.GraphedTrainStep) and not hasattr(step, "release")
    b = _batches(1, 6, 1)[0]
    staged = t._to_device(b)
    assert staged["xdata"].data_ptr() == torch.as_tensor(b["xdata"]).data_ptr()
    assert not t._staging


def _wrapped(monkeypatch, draws=False):
    """A GraphedTrainStep over a small CPU model whose capture and replay are
    stood in for: each call's path is logged, the replay runs the eager
    step, and a capture holds the model's tensors as the real one does."""
    cfg = get_config("geodesic_bd", **SMALL, compute_dtype="float32")
    model = build_model(cfg, "cpu")
    opt = Adam(list(model.parameters()), lr=1e-3)
    log = []

    def eager(state, batch):
        log.append("eager")
        for p in opt.param_groups[0]["params"]:
            p.grad = torch.zeros_like(p)
        opt.step()
        return state.replace(step=state.step + 1), {}

    wrapped = steps.GraphedTrainStep(eager, None, None, model, opt,
                                     list(model.parameters()), list(model.parameters()),
                                     draws=draws)

    def capture(self, layout, state, batch):
        log.append("capture")
        params = [p for p in opt.param_groups[0]["params"] if p.grad is not None]
        opt.captured = SimpleNamespace(
            covers=lambda groups: False,
            tensors=[(params, [p.grad for p in params], [opt.state[p]["mu"] for p in params],
                      [opt.state[p]["nu"] for p in params])])
        held = [(m._parameters, n, t) for m in model.modules() for n, t in m._parameters.items()]
        return steps._StepGraphs(layout, None, None, None, None, None, opt.captured, None,
                                 state.rng if draws else None, held, [0] * 7)

    def replay(self, g, state, batch):
        log.append("replay")
        return state.replace(step=state.step + 1), {}

    monkeypatch.setattr(steps.GraphedTrainStep, "_capture", capture)
    monkeypatch.setattr(steps.GraphedTrainStep, "_replay", replay)
    return wrapped, model, opt, log


def _tensors(n: int):
    return {"xdata": torch.zeros(n, 4, 4, 3, dtype=torch.uint8),
            "euler": torch.zeros(n, 3), "label": torch.zeros(n, dtype=torch.int32)}


def test_a_layout_is_captured_on_its_second_call_and_replayed_after(monkeypatch):
    """The first call runs eagerly, the second with the same layout captures
    and replays, later ones replay; a batch of another layout (a partial
    one) runs eagerly and the captured layout replays again after it; a
    state that no longer holds the captured tensors (a parameter replaced)
    captures anew; optimizer state cleared (init_state) runs eagerly until
    the moments exist again; release() drops the graphs and the optimizer's
    update captured with them."""
    wrapped, model, opt, log = _wrapped(monkeypatch)
    state = TrainState(0, model, opt, torch.zeros(()))
    for n in (6, 6, 6, 4, 6, 6):
        state, _ = wrapped(state, _tensors(n))
    assert log == ["eager", "capture", "replay", "replay", "eager", "replay", "replay"]
    log.clear()
    owner = next(m for m in model.modules() if m._parameters)
    name, p = next(iter(owner._parameters.items()))
    owner._parameters[name] = torch.nn.Parameter(p.detach().clone())
    state, _ = wrapped(state, _tensors(6))
    assert log == ["capture", "replay"]
    log.clear()
    opt.state.clear()
    state, _ = wrapped(state, _tensors(6))
    state, _ = wrapped(state, _tensors(6))
    assert log == ["eager", "capture", "replay"]
    assert opt.captured is not None
    wrapped.release()
    assert opt.captured is None and wrapped._graphs is None


def test_two_steps_called_in_turn_keep_their_own_graphs(monkeypatch):
    """Steps of two Trainers on one card called in turn each capture once and
    then replay: neither releases the other's graphs."""
    a, model, opt, log = _wrapped(monkeypatch)
    b = steps.GraphedTrainStep(a.eager, None, None, model, opt, list(model.parameters()),
                               list(model.parameters()), draws=False)
    state = TrainState(0, model, opt, torch.zeros(()))
    for step in (a, a, b, b, a, b):
        state, _ = step(state, _tensors(6))
    assert log == ["eager", "capture", "replay", "eager", "capture", "replay", "replay",
                   "replay"]
    assert a._graphs is not None and b._graphs is not None


def test_a_flip_step_follows_its_generator(monkeypatch):
    """Where the step draws flips, a state with another generator (a
    restored checkpoint's) captures anew, and a state with none runs the
    eager step, which raises as it always has."""
    wrapped, model, opt, log = _wrapped(monkeypatch, draws=True)
    g = torch.Generator().manual_seed(0)
    state = TrainState(0, model, opt, torch.zeros(()), rng=g)
    for _ in range(3):
        state, _ = wrapped(state, _tensors(6))
    state, _ = wrapped(state.replace(rng=torch.Generator().manual_seed(0)), _tensors(6))
    assert log == ["eager", "capture", "replay", "replay", "capture", "replay"]
    log.clear()
    wrapped(state.replace(rng=None), _tensors(6))
    assert log == ["eager"]


def test_a_failed_capture_leaves_the_step_eager(monkeypatch):
    """A capture that raises RuntimeError runs that step eagerly, warns once,
    keeps the counters as they were, and every later call runs eagerly."""
    wrapped, model, opt, log = _wrapped(monkeypatch)

    def capture(self, layout, state, batch):
        log.append("capture")
        self.failure = "RuntimeError: operation not permitted when stream is capturing"
        return None

    monkeypatch.setattr(steps.GraphedTrainStep, "_capture", capture)
    state = TrainState(0, model, opt, torch.zeros(()))
    for _ in range(4):
        state, _ = wrapped(state, _tensors(6))
    assert log == ["eager", "capture", "eager", "eager", "eager"]
    assert state.step == 4


# --- on the card ------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _trainer(dev, monkeypatch, graphed: bool, flip: bool, **kw):
    """A small bf16 Trainer on the card; graphed=False builds its main step
    eager, and with graphed=None its step is graphed whatever graph_blocker
    says."""
    cfg = get_config("geodesic_bd", **SMALL, compute_dtype="bfloat16", stem_pool="kernel",
                     optimizer_dtype="bfloat16", train_flip=flip, epoch_lr_decay="inv", **kw)
    t = Trainer(cfg, dictionary=CENTERS, device=dev)
    if not graphed:
        with monkeypatch.context() as m:
            m.setattr(steps, "graph_blocker",
                      lambda *a: None if graphed is None else "eager for the comparison")
            t.train_step_fn("main", dual_stream=True)
    return t


def _snapshot(t: Trainer, state: TrainState) -> dict:
    torch.cuda.synchronize()
    out = {f"model.{k}": v.clone() for k, v in t.model.state_dict().items()}
    for i, p in enumerate(t._params()):
        st = t.optimizer.state.get(p, {})
        out |= {f"adam.{i}.{k}": (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in st.items()}
    out["s"] = state.s.clone()
    out["rng"] = None if state.rng is None else state.rng.get_state()
    out["step"] = state.step
    out["lr"] = t.optimizer.param_groups[0]["lr"]
    return out


def _assert_same(a: dict, b: dict, when: str) -> None:
    assert a.keys() == b.keys(), when
    for k, v in a.items():
        w = b[k]
        same = torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w
        assert same, f"{when}: {k}"


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.cuda
@pytest.mark.parametrize("flip", [False, True], ids=["no_flip", "flip"])
def test_graphed_steps_equal_eager_steps(dev, monkeypatch, flip):
    """Two small bf16 Trainers from one seed, one graphed and one forced
    eager, run the same main passes through run_epoch (every step logged):
    3 steps, an apply_epoch_lr change, 2 steps, a pass whose second batch
    is partial (4 images a stream, not 6), then 2 steps. After every pass
    the parameters, BN statistics, Adam's moments and counts, s, the
    generator's state, the rate and every logged metric are bit-equal; the
    graphed Trainer replayed every full step but the first of a layout and
    ran the partial one eagerly."""
    runs = {}
    for graphed in (True, False):
        t = _trainer(dev, monkeypatch, graphed, flip)
        state = t.init_state()
        snaps = []
        real, render = _batches(11, 6, 8), _batches(12, 6, 8)
        small_real, small_render = _batches(13, 4, 1), _batches(14, 4, 1)
        plan = [(real[:3], render[:3], None), (real[3:5], render[3:5], 1),
                ([real[5], small_real[0]], [render[5], small_render[0]], None),
                (real[6:8], render[6:8], None)]
        for r, d, epoch in plan:
            if epoch is not None:
                state = t.apply_epoch_lr(state, epoch)
            state = t.run_epoch(state, _Loader(r), _Loader(d), "main", log_every=1)
            snaps.append(_snapshot(t, state))
        step = t.train_step_fn("main", dual_stream=True)
        runs[graphed] = (snaps, [{k: r[k] for k in ("loss", "lc", "lr", "s", "alpha")}
                                 for r in t.history], step)
    (sg, hg, step_g), (se, he, step_e) = runs[True], runs[False]
    assert isinstance(step_g, steps.GraphedTrainStep) and not isinstance(
        step_e, steps.GraphedTrainStep)
    assert step_g.failure is None and step_g.replays == 7
    assert sg[1]["lr"] != sg[0]["lr"]
    for i, (a, b) in enumerate(zip(sg, se)):
        _assert_same(a, b, f"after pass {i}")
    assert hg == he


@pytest.mark.cuda
@pytest.mark.parametrize("flip", [False, True], ids=["no_flip", "flip"])
def test_a_capture_changes_no_state(dev, monkeypatch, flip):
    """After one eager step, a capture of the step leaves the parameters, BN
    statistics, Adam's moments and counts, s and the generator's state as
    they were, and the launch counters too; the replay that follows then
    counts the step's launches (1 normalize, 2 stem, 2 stem backward, 1
    Adam)."""
    from multi_modal_regression_tpu_torch.ops import adam as adam_ops
    from multi_modal_regression_tpu_torch.ops import preprocess, stem_pool

    t = _trainer(dev, monkeypatch, True, flip)
    state = t.init_state()
    step = t.train_step_fn("main", dual_stream=True)
    real, render = _batches(21, 6, 2), _batches(22, 6, 2)
    batch = t._to_device({k: np.concatenate([real[0][k], render[0][k]]) for k in real[0]}
                         | {"is_real": np.arange(12) < 6})
    state, _ = step(state, batch)
    before = _snapshot(t, state)

    def counts():
        return (preprocess.launches, stem_pool.launches, stem_pool.bwd_launches,
                adam_ops.launches)

    c0 = counts()
    g = step._capture(steps._layout(batch, dev), state, batch)
    assert g is not None and counts() == c0
    _assert_same(_snapshot(t, state), before, "after the capture")
    step._graphs = g
    state, _ = step._replay(g, state, batch)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(c0, counts())) == (1, 2, 2, 1)
    assert state.step == 2 and all(st["count"] == 2 for st in t.optimizer.state.values())


@pytest.mark.cuda
def test_a_capture_that_fails_leaves_the_step_eager(dev, monkeypatch):
    """A step that graph_blocker would keep eager (device_resize_from: its
    forward copies resize matrices from the host), made graphed anyway,
    fails its capture on the second call: it warns, runs that step and
    every later one eagerly, counts its launches as the eager step does,
    and ends bit-equal to the eager Trainer."""
    from multi_modal_regression_tpu_torch.ops import adam as adam_ops

    out = []
    for graphed in (None, False):
        t = _trainer(dev, monkeypatch, graphed, False, device_resize_from=40)
        state = t.init_state()
        real, render = _batches(31, 6, 4, size=40), _batches(32, 6, 4, size=40)
        n0 = adam_ops.launches
        with pytest.warns(UserWarning, match="capture failed") if graphed is None else \
                contextlib.nullcontext():
            state = t.run_epoch(state, _Loader(real), _Loader(render), "main", log_every=1)
        torch.cuda.synchronize()
        assert adam_ops.launches - n0 == 4
        out.append((_snapshot(t, state), t.train_step_fn("main", dual_stream=True)))
    (sg, step_g), (se, _) = out
    assert isinstance(step_g, steps.GraphedTrainStep) and step_g.failure is not None
    assert step_g.replays == 0
    _assert_same(sg, se, "after the pass")
