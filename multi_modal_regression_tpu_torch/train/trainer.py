"""The Trainer: warm-up and main phases of steps (port of the JAX package's
train/trainer.py, as far as the geodesic_bd training path needs).

Each step consumes one real batch and one render batch, concatenated (the
reference zips two DataLoaders, learnGeodesicBDModel.py:160-173). Loaders
are any iterables of the BalancedLoader batch dicts: `xdata` uint8
(n, S, S, 3), `euler` float32 degrees (n, 3), `label` int32 (n,), as numpy
arrays or tensors; the host loaders themselves are not ported yet.

Checkpoints (`workdir`) and MedErr evaluation (`test_loader`) come with the
loaders and metrics slice and raise until then (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from multi_modal_regression_tpu_torch.losses.self_balance import init_log_balance
from multi_modal_regression_tpu_torch.train.presets import (
    ExperimentConfig,
    build_model,
    build_optimizer,
    build_problem,
    resolve_compute_dtype,
)
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.steps import (
    make_train_step,
    validate_dual_stream_layout,
)

_METRIC_KEYS = ("loss", "lc", "lr", "s", "alpha")


def _interleave(real_loader: Iterable, render_loader: Iterable | None):
    """Yield concatenated (real, render) batches; stop at the shorter (zip
    semantics of the reference, learnGeodesicBDModel.py:160). Adds a host
    'is_real' row mask. With render_loader None (the single-loader
    protocol) the real batches pass through unchanged."""
    if render_loader is None:
        yield from real_loader
        return
    mask = None
    for a, b in zip(real_loader, render_loader):
        out = {k: np.concatenate([np.asarray(a[k]), np.asarray(b[k])]) for k in a}
        if mask is None or len(mask) != len(out["label"]):
            mask = np.concatenate(
                [np.ones(len(a["label"]), bool), np.zeros(len(b["label"]), bool)]
            )
        out["is_real"] = mask
        yield out


def _no_test_loader(test_loader) -> None:
    if test_loader is not None:
        raise NotImplementedError(
            "evaluation during fit (test_loader, MedErr) comes with the loaders "
            "and metrics slice (ROADMAP.md)"
        )


class Trainer:
    """Model, problem and optimizer of one experiment, and the loop over them.

    device: where the model, the batches and the state live (the kernels
    run on a CUDA device; a CPU device takes their plain versions).
    The model keeps float32 master weights (float64 for a float64 run) and
    computes in cfg.compute_dtype, as the JAX package does.
    """

    def __init__(
        self, config: ExperimentConfig, dictionary=None, workdir=None,
        device: torch.device | str = "cuda",
    ):
        if workdir is not None:
            raise NotImplementedError(
                "checkpoints (workdir) come with the loaders and metrics slice "
                "(ROADMAP.md)"
            )
        self.config = config
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(config.compute_dtype)
        self.model = build_model(
            config, self.device,
            param_dtype=torch.promote_types(torch.float32, self.compute_dtype),
        )
        self.problem = build_problem(config, dictionary, self.device)
        self.optimizer = build_optimizer(config, self.model.parameters())
        self._train_steps: dict = {}
        self.history: list[dict] = []  # the logged records, in order

    def train_step_fn(self, phase: str = "main", dual_stream: bool = False):
        """The train step for a phase; dual_stream=True is the per-stream-BN
        variant (the reference's two-forward dual-loader protocol). Built on
        first request."""
        key = (phase, dual_stream)
        if key not in self._train_steps:
            cfg = self.config
            self._train_steps[key] = make_train_step(
                self.model, self.problem, self.optimizer,
                phase=phase,
                alpha=cfg.alpha if phase == "main" else cfg.warmup_alpha,
                dual_stream_bn=dual_stream,
                dual_loss_sum=dual_stream and cfg.loss_stream_sum,
                dual_stream_fused=cfg.bn_stream_fused,
                compute_dtype=self.compute_dtype,
            )
        return self._train_steps[key]

    def init_state(self) -> TrainState:
        """Step 0, s = 0, the trainer's model (weights as built from
        cfg.seed or as loaded since) and its optimizer with no moments.
        Unlike the JAX init_state, the weights are not drawn again."""
        self.optimizer.state.clear()
        return TrainState(
            step=0, model=self.model, optimizer=self.optimizer,
            s=init_log_balance(self.device),
        )

    def _to_device(self, batch: dict) -> dict:
        return {
            k: torch.as_tensor(batch[k]).to(self.device)
            for k in ("xdata", "euler", "label")
        }

    def run_epoch(
        self, state: TrainState, real_loader: Iterable,
        render_loader: Iterable | None, phase: str, test_loader=None,
        log_every: int = 50,
    ) -> TrainState:
        """One pass over the zipped loaders (at most cfg.max_iterations
        steps). Steps 1, log_every, 2*log_every, ... are logged: one
        device-to-host fetch of the step's metrics each, printed and
        appended to self.history; no other step waits for the device."""
        _no_test_loader(test_loader)
        cfg = self.config
        use_dual = render_loader is not None and cfg.bn_per_stream
        step_fn = self.train_step_fn(phase, dual_stream=use_dual)
        n_steps = images_done = 0
        t0 = time.time()
        for batch in _interleave(real_loader, render_loader):
            if use_dual:
                validate_dual_stream_layout(batch)
            state, metrics = step_fn(state, self._to_device(batch))
            n_steps += 1
            images_done += len(batch["label"])
            if n_steps % log_every == 0 or n_steps == 1:
                values = torch.stack([metrics[k] for k in _METRIC_KEYS]).tolist()
                m = dict(zip(_METRIC_KEYS, values))
                rec = {
                    "step": state.step, "phase": phase, **m,
                    "train_loss": m["loss"],
                    "images_per_sec": images_done / max(time.time() - t0, 1e-9),
                }
                print(
                    f"[{phase}] step {state.step} loss {m['loss']:.4f} "
                    f"lc {m['lc']:.4f} lr {m['lr']:.4f} "
                    f"({rec['images_per_sec']:.1f} img/s)",
                    flush=True,
                )
                self.history.append(rec)
            if cfg.max_iterations and n_steps >= cfg.max_iterations:
                break
        return state

    def fit(
        self, state: TrainState, real_loader: Iterable,
        render_loader: Iterable | None, test_loader=None, log_every: int = 50,
    ) -> TrainState:
        """cfg.num_warmup_epochs warm-up epochs, s reset to 0 when
        cfg.reset_s_between_phases (learnGeodesicBDModel.py:240), then
        cfg.num_epochs main epochs."""
        _no_test_loader(test_loader)
        cfg = self.config
        for _ in range(cfg.num_warmup_epochs):
            state = self.run_epoch(
                state, real_loader, render_loader, "warmup", log_every=log_every
            )
        if cfg.reset_s_between_phases:
            state = state.replace(s=init_log_balance(self.device))
        for _ in range(cfg.num_epochs):
            state = self.run_epoch(
                state, real_loader, render_loader, "main", log_every=log_every
            )
        return state
