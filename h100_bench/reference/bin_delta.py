"""Bin-delta pose model, geodesic loss and Adam in plain PyTorch float32.

The model (binDeltaModels.py:99-178): a ResNet v1.5 trunk to `feature_layer`
with global average pooling, a per-class bin head bank (N0 -> N1 -> N2 ->
K, BN + ReLU between) and a per-class delta bank: one (N0 -> N1 -> N2 -> 3)
head a class, or with `multires` one (N0 -> N3 -> 3) head a (class, bin).
Every BN normalizes by the batch's biased moments in training mode and by
its running statistics in eval mode (eps 1e-5); a head bank's BN is per
(head, feature). The row's class picks its heads.

The loss (learnGeodesicBDModel.py, main phase): targets from the Euler
angles (R = Rz(ct) Rx(el) Rz(az), degrees; axis-angle by the log map), the
hard bin by the nearest atom, Lc the mean cross-entropy, Lr the mean
geodesic angle between the decoded pose (atom of the argmax bin + the
delta; the multires delta of that bin) and the target, loss = Lc +
exp(-s) Lr + s with s the log of the previous step's Lr (0 on the first).
The dual-loader step runs the real stream, then the render stream, each
with its own BN moments, the loss taken over both. Adam is optax's
(b1 0.9, b2 0.999, eps 1e-8), moments in float32.

Weights are a dict of float32 tensors named as `param_specs` lists them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from h100_bench.reference.precision import FLOAT32, Precision

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}
STAGES = {"layer2": 2, "layer3": 3, "layer4": 4}
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
EPS_BN = 1e-5
EPS_GEO = 1e-6


def _bn_specs(prefix: str, n: int, weight: str = "bn_weight") -> list[tuple]:
    return [(f"{prefix}.weight", (n,), weight, n), (f"{prefix}.bias", (n,), "bn_bias", n),
            (f"{prefix}.running_mean", (n,), "bn_mean", n),
            (f"{prefix}.running_var", (n,), "bn_var", n)]


def _conv_spec(name: str, cout: int, cin: int, k: int) -> tuple:
    return (name, (cout, cin, k, k), "conv", cin * k * k)


def trunk_blocks(cfg: dict) -> list[tuple[str, int, int, int]]:
    """(name, cin, width, stride) of each bottleneck block."""
    blocks, cin = [], 64
    for s in range(STAGES[cfg["feature_layer"]]):
        width = 64 * 2**s
        for b in range(STAGE_BLOCKS[cfg["feature_network"]][s]):
            blocks.append((f"layer{s + 1}_{b}", cin, width, 2 if s > 0 and b == 0 else 1))
            cin = 4 * width
    return blocks


def _bank_specs(prefix: str, heads: int, dims: list[int]) -> list[tuple]:
    specs = []
    for li in range(1, len(dims)):
        specs.append((f"{prefix}.fc{li}_kernel", (heads, dims[li - 1], dims[li]), "linear",
                      dims[li - 1]))
        if li == len(dims) - 1:
            specs.append((f"{prefix}.fc{li}_bias", (heads, dims[li]), "linear", dims[li - 1]))
        else:
            specs += [(n, (heads, dims[li]), kind, fan)
                      for n, _, kind, fan in _bn_specs(f"{prefix}.bn{li}", dims[li])]
    return specs


def param_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every weight and BN statistic.

    kind: 'conv', 'linear' (kernels and the last layers' biases),
    'bn_weight', 'bn_weight_branch_end' (the last BN of a residual branch),
    'bn_bias', 'bn_mean', 'bn_var'."""
    t = "feature_model"
    specs = [_conv_spec(f"{t}.conv1.weight", 64, 3, 7), *_bn_specs(f"{t}.bn1", 64)]
    for name, cin, w, stride in trunk_blocks(cfg):
        p = f"{t}.{name}"
        specs += [_conv_spec(f"{p}.conv1.weight", w, cin, 1), *_bn_specs(f"{p}.bn1", w),
                  _conv_spec(f"{p}.conv2.weight", w, w, 3), *_bn_specs(f"{p}.bn2", w),
                  _conv_spec(f"{p}.conv3.weight", 4 * w, w, 1),
                  *_bn_specs(f"{p}.bn3", 4 * w, "bn_weight_branch_end")]
        if stride != 1 or cin != 4 * w:
            specs += [_conv_spec(f"{p}.downsample_conv.weight", 4 * w, cin, 1),
                      *_bn_specs(f"{p}.downsample_bn", 4 * w)]
    c, k, n0 = cfg["num_classes"], cfg["dict_size"], cfg["N0"]
    specs += _bank_specs("bin_models", c, [n0, cfg["N1"], cfg["N2"], k])
    if cfg["multires"]:
        specs += _bank_specs("res_models", c * k, [n0, cfg["N3"], cfg["ndim"]])
    else:
        specs += _bank_specs("res_models", c, [n0, cfg["N1"], cfg["N2"], cfg["ndim"]])
    return specs


def trained(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


# -- forward ---------------------------------------------------------------

def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 (B, 3, H, W), ImageNet mean and std."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def _bn(x, W, p, train: bool, prec: Precision):
    if train:
        y = F.batch_norm(x, None, None, W[f"{p}.weight"], W[f"{p}.bias"], True, 0.0, EPS_BN)
    else:
        y = F.batch_norm(x, W[f"{p}.running_mean"], W[f"{p}.running_var"], W[f"{p}.weight"],
                         W[f"{p}.bias"], False, 0.0, EPS_BN)
    return prec.act(y)


def trunk(W: dict, cfg: dict, x: torch.Tensor, train: bool, prec: Precision) -> torch.Tensor:
    t, r = "feature_model", prec.act
    x = prec.conv(x, W[f"{t}.conv1.weight"], 2, 3)
    x = r(F.max_pool2d(r(torch.relu(_bn(x, W, f"{t}.bn1", train, prec))), 3, stride=2,
                       padding=1))
    for name, cin, w, stride in trunk_blocks(cfg):
        p = f"{t}.{name}"
        y = r(torch.relu(_bn(prec.conv(x, W[f"{p}.conv1.weight"], 1, 0), W, f"{p}.bn1", train,
                             prec)))
        y = r(torch.relu(_bn(prec.conv(y, W[f"{p}.conv2.weight"], stride, 1), W, f"{p}.bn2",
                             train, prec)))
        y = _bn(prec.conv(y, W[f"{p}.conv3.weight"], 1, 0), W, f"{p}.bn3", train, prec)
        if f"{p}.downsample_conv.weight" in W:
            x = _bn(prec.conv(x, W[f"{p}.downsample_conv.weight"], stride, 0), W,
                    f"{p}.downsample_bn", train, prec)
        x = r(torch.relu(r(y + x)))
    return r(x.mean(dim=(2, 3)))


def head_bank(W: dict, prefix: str, x: torch.Tensor, train: bool, prec: Precision) -> torch.Tensor:
    """(B, I) -> (B, H, O): every head of the bank on every row."""
    h, li = x, 1
    while f"{prefix}.fc{li}_kernel" in W:
        h = prec.matmul(h, W[f"{prefix}.fc{li}_kernel"])  # (H, B, O)
        if f"{prefix}.fc{li}_bias" in W:
            h = prec.act(h + W[f"{prefix}.fc{li}_bias"][:, None, :])
        else:
            p = f"{prefix}.bn{li}"
            if train:
                mean = h.mean(dim=1, keepdim=True)
                var = torch.square(h - mean).mean(dim=1, keepdim=True)
            else:
                mean, var = W[f"{p}.running_mean"][:, None, :], W[f"{p}.running_var"][:, None, :]
            h = prec.act((h - mean) * torch.rsqrt(var + EPS_BN) * W[f"{p}.weight"][:, None, :]
                         + W[f"{p}.bias"][:, None, :])
            h = prec.act(torch.relu(h))
        li += 1
    return h.transpose(0, 1)


def forward(W: dict, cfg: dict, images_u8: torch.Tensor, labels: torch.Tensor, train: bool,
            prec: Precision = FLOAT32) -> tuple[torch.Tensor, torch.Tensor]:
    """scores (B, K) and the row's class's deltas: (B, 3), or (B, K, 3)
    for multires (one a bin)."""
    feat = trunk(W, cfg, prec.act(normalize(images_u8)), train, prec)
    rows = torch.arange(labels.shape[0], device=labels.device)
    lab = labels.to(torch.int64)
    scores = head_bank(W, "bin_models", feat, train, prec)[rows, lab]
    res = head_bank(W, "res_models", feat, train, prec)
    if cfg["multires"]:
        k = cfg["dict_size"]
        return scores, res.view(res.shape[0], cfg["num_classes"], k, -1)[rows, lab]
    return scores, res[rows, lab]


# -- geometry, targets, loss ----------------------------------------------------

def rotation_from_euler(euler_deg: torch.Tensor) -> torch.Tensor:
    """(B, 3) degrees (az, el, ct) -> (B, 3, 3) = Rz(ct) Rx(el) Rz(az)."""
    a, b, c = torch.deg2rad(euler_deg.to(torch.float64)).unbind(-1)

    def rz(t):
        z, o = torch.zeros_like(t), torch.ones_like(t)
        return torch.stack([torch.stack([t.cos(), -t.sin(), z], -1),
                            torch.stack([t.sin(), t.cos(), z], -1),
                            torch.stack([z, z, o], -1)], -2)

    z, o = torch.zeros_like(b), torch.ones_like(b)
    rx = torch.stack([torch.stack([o, z, z], -1), torch.stack([z, b.cos(), -b.sin()], -1),
                      torch.stack([z, b.sin(), b.cos()], -1)], -2)
    return rz(c) @ rx @ rz(a)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> axis-angle (angle in [0, pi])."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    cos = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    theta = torch.atan2(s[..., 0], cos)[..., None]
    return torch.where(s > 1e-6, theta * v / s.clamp(min=1e-30), torch.zeros_like(v))


def targets(euler_deg: torch.Tensor, atoms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Axis-angle poses (B, 3) float32 and their nearest atoms (B,)."""
    y = log_so3(rotation_from_euler(euler_deg))
    d = torch.cdist(y, atoms.to(torch.float64))
    return y.to(torch.float32), torch.argmin(d, dim=-1)


def geodesic(yp: torch.Tensor, yt: torch.Tensor) -> torch.Tensor:
    """Per-row angle of the relative rotation between two axis-angle poses
    (axisAngle.geodesic_loss: the quaternion product's scalar part)."""
    ap, at = torch.linalg.vector_norm(yp, dim=-1), torch.linalg.vector_norm(yt, dim=-1)
    up, ut = yp / ap.clamp(min=1e-12)[..., None], yt / at.clamp(min=1e-12)[..., None]
    c = torch.abs(torch.cos(at / 2) * torch.cos(ap / 2)
                  + torch.sin(at / 2) * torch.sin(ap / 2) * (ut * up).sum(-1))
    return 2.0 * torch.arccos(c.clamp(-1.0 + EPS_GEO, 1.0 - EPS_GEO))


def decode(scores: torch.Tensor, deltas: torch.Tensor, atoms: torch.Tensor) -> torch.Tensor:
    k = torch.argmax(scores, dim=-1)
    if deltas.ndim == 3:
        deltas = deltas[torch.arange(k.shape[0], device=k.device), k]
    return atoms[k] + deltas


def candidates(deltas: torch.Tensor, atoms: torch.Tensor) -> torch.Tensor:
    """(B, K, 3): the pose each bin would decode to."""
    return atoms[None] + (deltas if deltas.ndim == 3 else deltas[:, None, :])


def row_losses(scores, deltas, y, bins, atoms) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row cross-entropy and geodesic angle of the decoded pose."""
    lc = F.cross_entropy(scores, bins, reduction="none")
    return lc, geodesic(decode(scores, deltas, atoms), y)


# -- training ----------------------------------------------------------------

def train_steps(W0: dict, cfg: dict, batches: list, atoms: torch.Tensor, lr: float,
                prec: Precision = FLOAT32, half_rows: bool = False) -> dict:
    """len(batches) dual-stream main-phase steps from weights W0.

    batches: [(real, render)], each a dict of `xdata` uint8, `euler` degrees
    and `label` tensors on the device. half_rows: the loss is the mean over
    the first half of each stream's rows (a fault for the comparison's
    check). Returns each step's loss and cross-entropy term, every trained
    leaf's gradient at step 1, its distance from W0 after the last step,
    and the quartiles (0, 1/4, 1/2) of step 1's top-2 score margins."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    P = {k: v.clone().requires_grad_(trained(k)) for k, v in W0.items()}
    names = [k for k in P if trained(k)]
    mu = {k: torch.zeros_like(P[k]) for k in names}
    nu = {k: torch.zeros_like(P[k]) for k in names}
    s, losses, lcs, grad, margins = 0.0, [], [], {}, []
    for step, streams in enumerate(batches, start=1):
        for k in names:
            P[k].grad = None
        rows = sum(int(b["label"].shape[0]) for b in streams)
        used = rows // 2 if half_rows else rows
        lc_sum = lr_sum = 0.0
        for b in streams:  # real, then render: each with its own BN moments
            scores, deltas = forward(P, cfg, b["xdata"], b["label"], True, prec)
            if step == 1:
                top2 = torch.topk(scores.detach(), 2, dim=-1).values
                margins.append(top2[:, 0] - top2[:, 1])
            y, bins = targets(b["euler"], atoms)
            lc, lg = row_losses(scores, deltas, y, bins, atoms)
            if half_rows:
                lc, lg = lc[: lc.shape[0] // 2], lg[: lg.shape[0] // 2]
            ((lc.sum() + math.exp(-s) * lg.sum()) / used).backward()
            lc_sum, lr_sum = lc_sum + float(lc.detach().sum()), lr_sum + float(lg.detach().sum())
        lc_m, lr_m = lc_sum / used, lr_sum / used
        losses.append(lc_m + math.exp(-s) * lr_m + s)
        lcs.append(lc_m)
        if step == 1:
            grad = {k: P[k].grad.clone() for k in names}
        bc1, bc2 = 1 - b1**step, 1 - b2**step
        with torch.no_grad():
            for k in names:
                g = P[k].grad
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                P[k].sub_(lr * (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + eps))
        s = math.log(max(lr_m, 1e-30))
    change = {k: float(torch.linalg.vector_norm((P[k].detach() - W0[k]).double()))
              for k in names}
    m = torch.cat(margins).double()
    q = torch.quantile(m, torch.tensor([0.0, 0.25, 0.5], dtype=m.dtype, device=m.device))
    return {"loss": losses, "lc": lcs, "grad": grad, "change": change,
            "margins": [float(v) for v in q]}


@torch.no_grad()
def eval_candidates(W: dict, cfg: dict, images_u8, labels, atoms,
                    prec: Precision = FLOAT32) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode scores (B, K) and candidate poses (B, K, 3) of a request."""
    scores, deltas = forward(W, cfg, images_u8, labels, False, prec)
    return scores, candidates(deltas, atoms)
