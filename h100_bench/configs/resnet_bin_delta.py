"""The bin-delta pose models on a ResNet bottleneck trunk (geodesic_bd and
its multires form): the port's config for a configuration file, the
model's FLOPs and the calls of the port's kernels #1, #2 and #8.

FLOPs count the convolutions and products that the model's equations need
for the given images (2 per multiply-add): the trunk's convolutions, and of
the head banks only each row's own heads: its class's bin head and delta
head, or for multires its class's K delta heads. Nothing the program
computes and throws away is counted, and the count is the same whatever
implements the model. A training step's backward takes two products per
forward product (the input's and the weight's gradient), except that the
first convolution needs no input gradient.
"""

from __future__ import annotations

from h100_bench.reference.bin_delta import trunk_blocks

# configuration keys that are the port's ExperimentConfig fields
PORT_KEYS = ("feature_network", "feature_layer", "num_classes", "dict_size", "N0", "N1",
             "N2", "N3", "ndim", "image_size", "compute_dtype", "optimizer_dtype",
             "stem_pool", "init_lr")
MODEL_KEYS = ("model_kind", "problem", "multires")


def port_config(config: dict, traffic: dict, seed: int):
    """The port's ExperimentConfig of the configuration's preset, with its
    sizes and settings (and the traffic's items a class for training)."""
    from multi_modal_regression_tpu_torch.train.presets import get_config

    over = {k: config[k] for k in PORT_KEYS}
    if "items_per_batch" in traffic:
        over["items_per_batch"] = traffic["items_per_batch"]
    cfg = get_config(config["preset"], seed=seed % 2**31, **over)
    for k in MODEL_KEYS:
        if getattr(cfg, k) != config[k]:
            raise ValueError(f"preset {config['preset']!r} has {k}={getattr(cfg, k)!r}, "
                             f"the configuration file {config[k]!r}")
    return cfg


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def trunk_flops(config: dict) -> tuple[float, float]:
    """(forward FLOPs of the trunk for one image, of its first convolution)."""
    s = _out(config["image_size"], 7, 2, 3)
    conv1 = 2 * 64 * 3 * 49 * s * s
    total, h = conv1, _out(s, 3, 2, 1)
    for _, cin, w, stride in trunk_blocks(config):
        ho = _out(h, 3, stride, 1)
        total += 2 * (cin * w * h * h + w * w * 9 * ho * ho + w * 4 * w * ho * ho)
        if stride != 1 or cin != 4 * w:
            total += 2 * cin * 4 * w * ho * ho
        h = ho
    return float(total), float(conv1)


def head_flops(config: dict) -> float:
    """Forward FLOPs of one row's own heads."""
    n0, n1, n2, k = config["N0"], config["N1"], config["N2"], config["dict_size"]
    bins = 2 * (n0 * n1 + n1 * n2 + n2 * k)
    if config["multires"]:
        delta = k * 2 * (n0 * config["N3"] + config["N3"] * config["ndim"])
    else:
        delta = 2 * (n0 * n1 + n1 * n2 + n2 * config["ndim"])
    return float(bins + delta)


def flops(config: dict, images: int, train: bool) -> float:
    """Model FLOPs of a forward (serving) or a training step over `images`."""
    trunk, conv1 = trunk_flops(config)
    fwd = trunk + head_flops(config)
    return images * (3 * fwd - conv1 if train else fwd)


def kernel_calls(config: dict, images: int, streams: int, train: bool) -> list:
    """(kernel, dims) of each call of #1, #2 and #8 in one step or request:
    #1 over the whole batch, #2 (and in training #8) once a stream, on the
    first convolution's (B, 64, H, W) output."""
    itemsize = 2 if config["compute_dtype"] == "bfloat16" else 4
    size = config["image_size"]
    s = _out(size, 7, 2, 3)
    calls = [("normalize", dict(B=images, H=size, W=size, itemsize=itemsize))]
    if config["stem_pool"] == "kernel":
        stem = dict(B=images // streams, C=64, H=s, W=s, itemsize=itemsize)
        calls += [("stem_fwd", stem)] * streams
        if train:
            calls += [("stem_bwd", stem)] * streams
    return calls

