"""flax variables -> the port's state_dict.

`from_jax_variables` takes the JAX package's `params` and `batch_stats`
trees, as nested dicts of numpy arrays (e.g. `jax.device_get(state.params)`),
and returns a state_dict for the port's module of the same structure
(`OneBinDeltaModel`, `ResNetBackbone`, `MultiHeadMLP`): module names are the
same on both sides, so only leaf names and layouts change.

  conv `kernel` (kH, kW, I, O)      ->  `weight` (O, I, kH, kW)
  BN `scale` / `bias`               ->  `weight` / `bias`
  BN stats `mean` / `var`           ->  `running_mean` / `running_var`
  head banks `fc<i>_kernel` (H, I, O), `fc<i>_bias` (H, O), and the
  per-(head, feature) BN arrays (H, F)  ->  copied as they are

Trunk BNs (1-D statistics) are torch BatchNorm2d modules and also get
`num_batches_tracked` = 0. Everything is returned as float32;
`load_state_dict` casts to the model's dtypes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable C-order copy


def _walk(tree: Mapping, prefix: str):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, f"{prefix}{name}.")
        else:
            yield prefix, name, value


def from_jax_variables(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """Map flax (params, batch_stats) trees onto the port's state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for prefix, name, value in _walk(params, ""):
        if name == "kernel":
            a = np.asarray(value)
            if a.ndim != 4:
                raise ValueError(f"{prefix}kernel: expected an HWIO conv kernel")
            sd[f"{prefix}weight"] = _tensor(a.transpose(3, 2, 0, 1))
        elif name == "scale":
            sd[f"{prefix}weight"] = _tensor(value)
        else:  # BN `bias`, head-bank fc<i>_kernel / fc<i>_bias
            sd[f"{prefix}{name}"] = _tensor(value)
    for prefix, name, value in _walk(batch_stats, ""):
        if name not in _STATS:
            raise ValueError(f"unexpected batch_stats leaf {prefix}{name}")
        t = _tensor(value)
        sd[f"{prefix}{_STATS[name]}"] = t
        if name == "mean" and t.ndim == 1:
            sd[f"{prefix}num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
