"""Inputs made from the run's seed, on the device, in a few large calls:
weights, the pose dictionary's atoms, and host batches of images.

The same seed gives the same inputs on the same device. Each kind of input
draws from a generator of its own, seeded from (seed, kind), so the
weights do not depend on how many images a traffic mix makes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_KINDS = {"weights": 1, "atoms": 2, "real": 3, "render": 4, "requests": 5, "sample": 6,
          "bins": 7}
# the scale of each residual branch's last BN at the start (its weight):
# damped branches, as in zero-init-residual recipes (Goyal et al. 2017). With
# every BN weight at 1, a train-mode forward of the seeded ResNet50 turns
# bfloat16's rounding into a 16-24% error of the features' spread over the
# batch (float32 reference against its own bfloat16 rounding, H100), so
# bfloat16 and fp8 read alike; at 0.1 the error is 0.9% and they separate
BRANCH_END_WEIGHT = 0.1


def sub_seed(seed: int, kind: str) -> int:
    """A 63-bit seed for one kind of input of the run's seed (any integer)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), _KINDS[kind]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, kind: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, kind))


def draw_weights(specs, seed: int, device, eval_stats: bool) -> dict[str, torch.Tensor]:
    """float32 tensors named by `specs` ((name, shape, kind, fan_in)):
    convolution kernels uniform with variance 1/fan_in, linear kernels and
    biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's Linear), BN weights 1
    (a residual branch's last, BRANCH_END_WEIGHT) and biases 0; running
    means 0 and variances 1, or with eval_stats
    U(-0.2, 0.2) and U(0.5, 2), so that eval-mode BN is not the identity.
    One uniform draw covers every tensor."""
    random = {"conv", "linear"} | ({"bn_mean", "bn_var"} if eval_stats else set())
    total = sum(math.prod(shape) for _, shape, kind, _ in specs if kind in random)
    flat = torch.rand(total, generator=generator(seed, "weights", device), device=device)
    out, o = {}, 0
    for name, shape, kind, fan_in in specs:
        n = math.prod(shape)
        if kind in random:
            u = flat[o:o + n].view(shape)
            o += n
            lo, hi = {"conv": (-math.sqrt(3.0 / fan_in), math.sqrt(3.0 / fan_in)),
                      "linear": (-1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in)),
                      "bn_mean": (-0.2, 0.2), "bn_var": (0.5, 2.0)}[kind]
            out[name] = u * (hi - lo) + lo
        else:
            fill = {"bn_weight": 1.0, "bn_var": 1.0,
                    "bn_weight_branch_end": BRANCH_END_WEIGHT}.get(kind, 0.0)
            out[name] = torch.full(shape, fill, device=device)
    return out


def raise_bins(W: dict, seed: int, margin: float, device) -> None:
    """Add `margin` to the last bias of each bin head at one bin drawn from
    the seed, in place. Every row of a class then puts that bin first by
    about `margin` less the spread of its other scores, far above any
    rounding, so the regression term decodes the same bin in every
    precision and its gradient can be compared leaf by leaf."""
    (name,) = [n for n in W if n.startswith("bin_models.fc") and n.endswith("_bias")]
    bias = W[name]  # (heads, bins)
    k = torch.randint(bias.shape[1], (bias.shape[0],), generator=generator(seed, "bins", device),
                      device=device)
    bias[torch.arange(bias.shape[0], device=device), k] += margin


def draw_atoms(seed: int, k: int, device) -> torch.Tensor:
    """(k, 3) float32 axis-angle atoms: uniform directions, angles U(0, pi)."""
    g = generator(seed, "atoms", device)
    v = torch.randn(k, 3, generator=g, device=device, dtype=torch.float64)
    angle = torch.rand(k, 1, generator=g, device=device, dtype=torch.float64) * math.pi
    return (v / torch.linalg.vector_norm(v, dim=1, keepdim=True) * angle).to(torch.float32)


def draw_images(g: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """uint8 (n, size, size, 3): noise around each image's own brightness
    and contrast, so that pooled features vary across a batch as they do
    for real crops."""
    level = torch.rand(n, 1, 1, 3, generator=g, device=device) * 175 + 40
    spread = torch.rand(n, 1, 1, 1, generator=g, device=device) * 55 + 5
    noise = torch.randn(n, size, size, 3, generator=g, device=device)
    return (level + spread * noise).clamp_(0, 255).to(torch.uint8)


def draw_euler(g: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, 3) float32 degrees: azimuth U(-180, 180), elevation U(-30, 60),
    tilt U(-20, 20)."""
    u = torch.rand(n, 3, generator=g, device=device)
    lo = torch.tensor([-180.0, -30.0, -20.0], device=device)
    hi = torch.tensor([180.0, 60.0, 20.0], device=device)
    return lo + u * (hi - lo)


def train_ring(seed: int, stream: str, batches: int, items: int, classes: int,
               size: int, device) -> list[dict]:
    """`batches` host batches of one loader, as the BalancedLoader yields
    them: `items` images of each class, uint8 images, float32 Euler degrees,
    int32 labels (numpy)."""
    g = generator(seed, stream, device)
    n = items * classes
    labels = np.tile(np.arange(classes), items).astype(np.int32)
    return [{"xdata": draw_images(g, n, size, device).cpu().numpy(),
             "euler": draw_euler(g, n, device).cpu().numpy(),
             "label": labels.copy()} for _ in range(batches)]


def request_ring(seed: int, requests: int, size_of, classes: int, image_size: int,
                 device) -> list[tuple[np.ndarray, np.ndarray]]:
    """`requests` distinct host requests (uint8 images, int64 labels spread
    over the classes); size_of(i) is the i-th request's number of crops."""
    g = generator(seed, "requests", device)
    out = []
    for i in range(requests):
        n = size_of(i)
        perm = torch.randperm(n, generator=g, device=device).cpu().numpy()
        out.append((draw_images(g, n, image_size, device).cpu().numpy(),
                    (perm % classes).astype(np.int64)))
    return out


def sample(seed: int, population: int, k: int) -> list[int]:
    """k distinct indices of range(population), drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    return sorted(rng.choice(population, size=min(k, population), replace=False).tolist())
