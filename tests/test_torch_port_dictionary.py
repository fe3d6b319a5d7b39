"""The PyTorch port's pose-dictionary path vs the JAX package, on CPU.

The assign op's plain version (what the wrapper runs for CPU tensors) against
the JAX Pallas kernel in interpret mode and the JAX fallback; Lloyd and EM
from a given start against the JAX loops from the same start; kmeans++ by
its properties (the two packages' random streams differ); the fits on
planted blobs; get_gamma; `cli dictionary` on a small tree of named files.
Inputs come from numpy generators with fixed seeds; each test states its
tolerance.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.data.naming import make_name as jax_make_name
from multi_modal_regression_tpu.data.naming import parse_name as jax_parse_name
from multi_modal_regression_tpu.dictionary import gmm as jax_gmm
from multi_modal_regression_tpu.dictionary import kmeans as jax_kmeans
from multi_modal_regression_tpu.dictionary.common import get_gamma as jax_get_gamma
from multi_modal_regression_tpu.ops.assign import _pallas_assign, assign_bins_pallas
from multi_modal_regression_tpu.tools.parity import (
    gather_tree_poses as jax_gather_tree_poses,
)
from multi_modal_regression_tpu_torch import cli, dictionary
from multi_modal_regression_tpu_torch.data.index import ClassBalancedIndex
from multi_modal_regression_tpu_torch.data.naming import make_name, parse_name
from multi_modal_regression_tpu_torch.dictionary import gmm, kmeans
from multi_modal_regression_tpu_torch.dictionary.common import get_gamma
from multi_modal_regression_tpu_torch.ops import assign
from multi_modal_regression_tpu_torch.tools.parity import (
    fit_pose_dictionary,
    gather_tree_poses,
)


def _interpreted(fn, *args, **kwargs):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args, **kwargs)


def planted_clusters(rng, k=4, per=100, d=3, spread=0.05):
    centers = rng.uniform(-2, 2, (k, d))
    pts = centers[np.repeat(np.arange(k), per)] + spread * rng.standard_normal((k * per, d))
    return centers, pts.astype(np.float32)


def separated_blobs(rng, per=60, d=3, spread=0.05):
    """Four blobs at fixed, far-apart corners: every sensible start converges
    to the same optimum."""
    corners = np.array([[2, 2, 2, 2], [-2, -2, 2, -2], [2, -2, -2, 2], [-2, 2, -2, -2]], float)
    pts = corners[np.repeat(np.arange(4), per), :d] + spread * rng.standard_normal((4 * per, d))
    return corners[:, :d], pts.astype(np.float32)


# --- the assign op ---------------------------------------------------------------


@pytest.mark.parametrize("k", [5, 16, 200])
@pytest.mark.parametrize("d", [3, 4])
def test_assign_plain_matches_jax_kernel_and_fallback(d, k):
    """Equal indices (array_equal) against the Pallas kernel in interpret
    mode (row tile 64, N = 257: a ragged last tile) and against the JAX
    fallback, which ranks by the clamped full distance; int32 out; the
    wrapper takes the plain version for CPU tensors and counts no launch."""
    rng = np.random.default_rng(100 * d + k)
    y = rng.standard_normal((257, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    got = assign.assign_bins_plain(torch.from_numpy(y), torch.from_numpy(c))
    assert got.dtype == torch.int32 and got.shape == (257,)
    want = np.asarray(_interpreted(_pallas_assign, jnp.asarray(y), jnp.asarray(c), 64))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    fallback = np.asarray(assign_bins_pallas(jnp.asarray(y), jnp.asarray(c), use_pallas=False))
    np.testing.assert_array_equal(got.numpy(), fallback)
    before = assign.launches
    via_wrapper = assign.assign_bins(torch.from_numpy(y), torch.from_numpy(c))
    assert assign.launches == before and via_wrapper.dtype == torch.int32
    np.testing.assert_array_equal(via_wrapper.numpy(), want)


def test_assign_ties_nan_and_casts_match_jax():
    """Duplicate centers: the lower index on both sides. A NaN row, and a
    NaN center: the index of the first NaN distance, as the JAX kernel and
    jnp.argmin give it. float64 and non-contiguous inputs are cast to
    float32 and give the float32 answer; N = 0 gives an empty int32 tensor;
    the output never requires grad."""
    rng = np.random.default_rng(7)
    y = rng.standard_normal((64, 3)).astype(np.float32)
    c = rng.standard_normal((8, 3)).astype(np.float32)
    c[5] = c[2]
    c[7] = c[0]
    y[:8] = c  # rows that sit exactly on a center, two of them duplicated
    got = assign.assign_bins(torch.from_numpy(y), torch.from_numpy(c)).numpy()
    want = np.asarray(_interpreted(_pallas_assign, jnp.asarray(y), jnp.asarray(c), 64))
    np.testing.assert_array_equal(got, want)
    assert not {5, 7} & set(got.tolist())
    assert got[5] == 2 and got[7] == 0

    y_nan = y.copy()
    y_nan[3, 1] = np.nan
    c_nan = c.copy()
    c_nan[4, 0] = np.nan
    for yy, cc in ((y_nan, c), (y, c_nan)):
        got = assign.assign_bins(torch.from_numpy(yy), torch.from_numpy(cc)).numpy()
        want = np.asarray(_interpreted(_pallas_assign, jnp.asarray(yy), jnp.asarray(cc), 64))
        np.testing.assert_array_equal(got, want)
    assert got.tolist() == [4] * 64  # the NaN center takes every row

    y64 = torch.from_numpy(y.astype(np.float64))
    wide = torch.from_numpy(np.concatenate([y, y], axis=1))[:, ::2]  # a strided view
    assert not wide.is_contiguous()
    base = assign.assign_bins(torch.from_numpy(y), torch.from_numpy(c))
    assert torch.equal(assign.assign_bins(y64, torch.from_numpy(c)), base)
    ref = assign.assign_bins(wide.contiguous(), torch.from_numpy(c))
    assert torch.equal(assign.assign_bins(wide, torch.from_numpy(c)), ref)
    empty = assign.assign_bins(torch.zeros((0, 3)), torch.from_numpy(c))
    assert empty.shape == (0,) and empty.dtype == torch.int32
    out = assign.assign_bins(torch.from_numpy(y).requires_grad_(), torch.from_numpy(c))
    assert not out.requires_grad


def test_assign_rejects_what_it_does_not_take():
    y, c = torch.zeros((4, 3)), torch.zeros((5, 3))
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        assign.assign_bins(y, torch.zeros((5, 4)))
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        assign.assign_bins(torch.zeros(4), c)
    with pytest.raises(ValueError, match="at least one center"):
        assign.assign_bins(y, torch.zeros((0, 3)))
    with pytest.raises(TypeError, match="floating"):
        assign.assign_bins(y.long(), c)
    with pytest.raises(ValueError, match="unsupported device"):
        assign.assign_bins(y.to("meta"), c.to("meta"))


@pytest.mark.parametrize(
    "n,d,k,want",
    [
        # (blocks, tiles, most tiles a block walks) on 132 SMs at 3 blocks
        # an SM (grid 396), tiles of 256 rows
        (2_000_000, 3, 200, (396, 7813, 20)),  # the default fit's rows
        (2_000_000, 4, 200, (264, 7813, 30)),  # D = 4: 2 blocks an SM
        (810_753, 3, 200, (396, 3168, 8)),
        (810_752, 3, 200, (396, 3167, 8)),
        (101_375, 3, 200, (396, 396, 1)),  # one tile a block
        (101_377, 3, 200, (396, 397, 2)),  # one tile more: one block walks 2
        (257, 3, 16, (2, 2, 1)),  # fewer tiles than blocks: a block a tile
        (1, 1, 1, (1, 1, 1)),
        (4096, 2, 4096, (16, 16, 1)),  # K (D + 1) at the limit: 64 KB, 3 an SM
        (2_000_000, 1, 6144, (264, 7813, 30)),  # 96 KB: 2 blocks an SM
        (2_000_000, 4, 2457, (264, 7813, 30)),  # 2 slots a center: 76.8 KB
        (67_583, 4, 200, (264, 264, 1)),  # D = 4: one tile a block
        (67_585, 4, 200, (264, 265, 2)),
    ],
)
def test_assign_plan(n, d, k, want):
    """As many blocks as share the card at once (3 an SM, 2 at D = 4, fewer
    where the centers' shared memory does not allow it), never more than tiles; the
    tiles shared out so that blocks differ by at most one (a full last
    wave); 8 rows a thread, so tiles of 256 rows; one 16-byte slot a
    center, two at D = 4."""
    plan = assign._assign_plan(n, d, k, 132)
    runs = [plan.tiles * (b + 1) // plan.blocks - plan.tiles * b // plan.blocks
            for b in range(plan.blocks)]
    assert (plan.blocks, plan.tiles, max(runs)) == want
    assert plan.smem == k * (16 if d < 4 else 32)
    assert plan.tiles == -(-n // 256)
    assert sum(runs) == plan.tiles and max(runs) - min(runs) <= 1
    per_sm = min(3 if d < 4 else 2, 228 * 1024 // (plan.smem + 1024))
    assert plan.blocks == min(132 * per_sm, plan.tiles)


@pytest.mark.parametrize("n,d,k,sms", [
    (256 * 2**31, 3, 200, 132),  # 2**31 tiles of 256 rows
    (0, 3, 200, 132),
    (10, 5, 200, 132),
    (10, 3, 0, 132),
    (10, 4, 20_000, 132),  # centers beyond an SM's shared memory
])
def test_assign_plan_raises(n, d, k, sms):
    with pytest.raises(ValueError):
        assign._assign_plan(n, d, k, sms)


def test_predict_and_residuals_match_jax_class(tmp_path):
    """One .npz read by both classes: equal bins (int32), residuals within
    atol 1e-7; a given `bins` is used as it is."""
    rng = np.random.default_rng(8)
    y = rng.standard_normal((300, 3)).astype(np.float32)
    path = tmp_path / "kmeans.npz"
    kmeans.KMeansDictionary(rng.standard_normal((16, 3)).astype(np.float32), 1.5).save(path)
    port, ref = kmeans.KMeansDictionary.load(path), jax_kmeans.KMeansDictionary.load(path)
    np.testing.assert_array_equal(port.cluster_centers, ref.cluster_centers)
    bins = port.predict(y, device="cpu")
    assert bins.dtype == np.int32
    np.testing.assert_array_equal(bins, ref.predict(y))
    np.testing.assert_allclose(port.residuals(y, device="cpu"), ref.residuals(y), atol=1e-7)
    np.testing.assert_allclose(
        port.residuals(torch.from_numpy(y), bins=np.zeros(300, np.int64)),
        y - port.cluster_centers[0], atol=0,
    )
    np.testing.assert_array_equal(
        kmeans.kmeans_assign(torch.from_numpy(y), torch.from_numpy(port.cluster_centers)).numpy(),
        np.asarray(jax_kmeans.kmeans_assign(jnp.asarray(y), jnp.asarray(ref.cluster_centers))),
    )


# --- Lloyd and kmeans++ ----------------------------------------------------------


@pytest.mark.parametrize("n_iters", [1, 5])
def test_lloyd_from_a_given_start_matches_jax(n_iters):
    """The JAX start is `_lloyd(key, y, k, num_iters=0)` (its kmeans++
    centers for that key); from it the port's `_lloyd` gives centers within
    rtol 1e-5 / atol 1e-6 and an inertia within rtol 1e-4 of
    `_lloyd(key, y, k, num_iters=n)`."""
    rng = np.random.default_rng(9)
    _, pts = separated_blobs(rng, per=80, spread=0.3)
    key = jax.random.key(3)
    start, inertia0 = jax_kmeans._lloyd(key, jnp.asarray(pts), 6, 0)
    want_c, want_i = jax_kmeans._lloyd(key, jnp.asarray(pts), 6, n_iters)
    got0 = kmeans._lloyd(torch.from_numpy(pts), torch.from_numpy(np.array(start)), 0)
    np.testing.assert_array_equal(got0[0].numpy(), np.asarray(start))
    np.testing.assert_allclose(float(got0[1]), float(inertia0), rtol=1e-4)
    got_c, got_i = kmeans._lloyd(
        torch.from_numpy(pts), torch.from_numpy(np.array(start)), n_iters
    )
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-4)


def test_lloyd_keeps_the_center_of_an_empty_cluster():
    """A start with one center far from every point: it takes no point and
    stays where it was, while the others move to their blobs' means; the
    cluster sums equal a float64 numpy recomputation within rtol 1e-6."""
    rng = np.random.default_rng(10)
    corners, pts = separated_blobs(rng)
    start = np.concatenate([corners, [[50.0, 50.0, 50.0]]]).astype(np.float32)
    centers, inertia = kmeans._lloyd(torch.from_numpy(pts), torch.from_numpy(start), 3)
    np.testing.assert_array_equal(centers[4].numpy(), start[4])
    want = np.stack([pts[i * 60 : (i + 1) * 60].astype(np.float64).mean(0) for i in range(4)])
    np.testing.assert_allclose(centers[:4].numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(inertia), ((pts.astype(np.float64) - np.repeat(want, 60, 0)) ** 2).sum(), rtol=1e-4
    )
    assign_ = torch.from_numpy(np.repeat(np.arange(4), 60))
    sums = kmeans._cluster_sums(torch.from_numpy(pts), assign_, 5).numpy()
    np.testing.assert_allclose(sums[:4], want * 60, rtol=1e-6)
    assert not sums[4].any()


def test_kmeans_pp_init_properties():
    """Same generator seed -> the same centers, another seed -> others;
    every center is a row of y; four separated blobs get one center each;
    the greedy pick keeps, among given candidates, the one with the least
    potential (a numpy recomputation of the JAX loop body)."""
    rng = np.random.default_rng(11)
    corners, pts = separated_blobs(rng)
    y = torch.from_numpy(pts)

    def init(seed, k=4):
        return kmeans._kmeans_pp_init(y, k, torch.Generator().manual_seed(seed)).numpy()

    a, b, c = init(0), init(0), init(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    rows = {tuple(r) for r in pts.tolist()}
    assert all(tuple(r) in rows for r in init(2, k=9).tolist())
    nearest = np.linalg.norm(a[:, None] - corners[None], axis=-1).argmin(1)
    assert sorted(nearest.tolist()) == [0, 1, 2, 3]

    dmin = ((pts - pts[0]) ** 2).sum(-1)
    cand_idx = np.array([5, 70, 130, 200, 70])
    d_cand = ((pts[:, None, :] - pts[cand_idx][None]) ** 2).sum(-1)
    new_dmin = np.minimum(dmin[:, None], d_cand)
    best = int(new_dmin.sum(0).argmin())
    got_c, got_d = kmeans._greedy_pick(y, torch.from_numpy(dmin), torch.from_numpy(cand_idx))
    np.testing.assert_array_equal(got_c.numpy(), pts[cand_idx[best]])
    np.testing.assert_allclose(got_d.numpy(), new_dmin[:, best], rtol=1e-5, atol=1e-5)
    assert 2 + int(math.log2(200)) == 9  # the candidates per center at K = 200
    # candidates follow their weights: a row of weight 0 is never drawn, and
    # two of three rows at weights 1 : 3 are drawn about 1 : 3
    w = torch.tensor([1.0, 0.0, 3.0])
    draws = kmeans._draw_candidates(w, 4000, torch.Generator().manual_seed(0))
    counts = torch.bincount(draws, minlength=3).tolist()
    assert counts[1] == 0 and 0.2 < counts[0] / 4000 < 0.3


def test_fit_kmeans_recovers_blobs_like_jax(tmp_path):
    """The planted-blob checks the JAX package asks of its own fit
    (tests/test_dictionary.py): centers within 0.1 of the planted ones,
    predict equal to the nearest center, residuals, the .npz round trip into
    both classes; and an inertia within 1% of the JAX fit's (other random
    streams, the same optimum)."""
    rng = np.random.default_rng(0)
    true_centers, pts = planted_clusters(rng)
    d = kmeans.fit_kmeans(pts, 4, seed=0, device="cpu")
    dist = np.linalg.norm(true_centers[:, None] - d.cluster_centers[None], axis=-1)
    assert np.all(dist.min(axis=1) < 0.1)
    bins = d.predict(pts, device="cpu")
    full = np.linalg.norm(pts[:, None] - d.cluster_centers[None], axis=-1)
    np.testing.assert_array_equal(bins, full.argmin(axis=1))
    np.testing.assert_allclose(
        d.residuals(pts, device="cpu"), pts - d.cluster_centers[bins], atol=1e-6
    )
    ref = jax_kmeans.fit_kmeans(pts, 4, seed=0)
    assert abs(d.inertia - ref.inertia) <= 0.01 * ref.inertia
    d.save(tmp_path / "kmeans.npz")
    for cls in (kmeans.KMeansDictionary, jax_kmeans.KMeansDictionary):
        back = cls.load(tmp_path / "kmeans.npz")
        np.testing.assert_array_equal(back.cluster_centers, d.cluster_centers)
        assert back.inertia == d.inertia
    again = kmeans.fit_kmeans(torch.from_numpy(pts), 4, seed=0, device="cpu")
    np.testing.assert_array_equal(again.cluster_centers, d.cluster_centers)
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        kmeans.fit_kmeans(pts[0], 4, device="cpu")


def test_fit_kmeans_quality_at_eight_clusters():
    """Eight overlapping blobs (spread 0.3), n_init 4: the port's inertia
    within 5% of the JAX fit's, the margin the JAX package allows itself
    against sklearn."""
    rng = np.random.default_rng(1)
    _, pts = planted_clusters(rng, k=8, per=60, spread=0.3)
    ours = kmeans.fit_kmeans(pts, 8, seed=0, n_init=4, device="cpu")
    ref = jax_kmeans.fit_kmeans(pts, 8, seed=0, n_init=4)
    assert ours.inertia <= ref.inertia * 1.05


# --- GMM ---------------------------------------------------------------------------


def _gmm_params(rng, k=5, d=3):
    means = rng.uniform(-2, 2, (k, d)).astype(np.float32)
    a = rng.standard_normal((k, d, d)).astype(np.float32) * 0.3
    covs = a @ a.transpose(0, 2, 1) + 0.05 * np.eye(d, dtype=np.float32)
    w = rng.uniform(0.5, 1.5, k).astype(np.float32)
    return means, covs, (w / w.sum()).astype(np.float32)


def test_gmm_log_resp_and_predict_proba_match_jax(monkeypatch):
    """`_log_resp` (responsibilities, log-likelihood) and the class's
    predict_proba / predict on the same parameters: rtol 1e-4, atol 1e-6;
    the row-blocked E-step gives the same numbers at any block size."""
    rng = np.random.default_rng(12)
    means, covs, w = _gmm_params(rng)
    y = rng.uniform(-2.5, 2.5, (200, 3)).astype(np.float32)
    want_r, want_ll = jax_gmm._log_resp(*(jnp.asarray(a) for a in (y, means, covs, w)))
    got_r, got_ll = gmm._log_resp(*(torch.from_numpy(a) for a in (y, means, covs, w)))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5)
    port = gmm.GMMDictionary(means, covs, w)
    ref = jax_gmm.GMMDictionary(means, covs, w)
    proba = port.predict_proba(y, device="cpu")
    assert proba.dtype == np.float32 and proba.shape == (200, 5)
    np.testing.assert_allclose(proba, ref.predict_proba(y), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(port.predict(y, device="cpu"), ref.predict(y))
    monkeypatch.setattr(gmm, "_BLOCK_ELEMS", 5 * 3 * 64)  # 64 rows, 1 component a block
    small_r, small_ll = gmm._log_resp(*(torch.from_numpy(a) for a in (y, means, covs, w)))
    np.testing.assert_allclose(small_r.numpy(), got_r.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(small_ll), float(got_ll), rtol=1e-6)
    blocked = gmm._weighted_covs(torch.from_numpy(y), torch.from_numpy(means), small_r)
    monkeypatch.undo()
    whole = gmm._weighted_covs(torch.from_numpy(y), torch.from_numpy(means), small_r)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_iters", [1, 4])
def test_em_from_a_given_start_matches_jax(n_iters):
    """means0 from the JAX `_em(key, ..., num_iters=0)`; then means within
    rtol 1e-4 / atol 1e-5, covariances within rtol 1e-3 / atol 1e-5, weights
    within rtol 1e-4 and the log-likelihood within rtol 1e-4 of the JAX
    `_em(key, ..., num_iters=n)`; covariances start at eye * var(y), the
    biased variance over all elements."""
    rng = np.random.default_rng(13)
    _, pts = planted_clusters(rng, k=4, per=80, spread=0.2)
    key = jax.random.key(5)
    start = jax_gmm._em(key, jnp.asarray(pts), 4, 0, 1e-6)
    want = jax_gmm._em(key, jnp.asarray(pts), 4, n_iters, 1e-6)
    got0 = gmm._em(torch.from_numpy(pts), torch.from_numpy(np.array(start[0])), 0, 1e-6)
    np.testing.assert_allclose(got0[1].numpy(), np.asarray(start[1]), rtol=1e-6)
    np.testing.assert_allclose(got0[1][0].numpy(), np.eye(3) * pts.var(), rtol=1e-5)
    assert float(got0[3]) == 0.0
    got = gmm._em(torch.from_numpy(pts), torch.from_numpy(np.array(start[0])), n_iters, 1e-6)
    tols = ((1e-4, 1e-5), (1e-3, 1e-5), (1e-4, 1e-6), (1e-4, 0))
    for g, w, (rtol, atol) in zip(got, want, tols):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


def test_fit_gmm_recovers_blobs_and_round_trips(tmp_path):
    """The planted-blob checks of tests/test_dictionary.py: means within 0.1,
    responsibilities normalized and confident on tight blobs; the .npz
    written by either class loads in the other with equal arrays."""
    rng = np.random.default_rng(0)
    true_centers, pts = planted_clusters(rng, spread=0.02)
    g = gmm.fit_gmm(pts, 4, seed=0, device="cpu")
    dist = np.linalg.norm(true_centers[:, None] - g.means[None], axis=-1)
    assert np.all(dist.min(axis=1) < 0.1)
    p = g.predict_proba(pts, device="cpu")
    assert p.shape == (len(pts), 4) and np.all(p >= 0)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-5)
    assert np.mean(p.max(axis=1) > 0.99) > 0.95
    np.testing.assert_allclose(g.weights.sum(), 1.0, atol=1e-5)
    assert np.isfinite(g.log_likelihood) and g.n_components == 4
    ref = jax_gmm.fit_gmm(pts, 4, seed=0)
    for writer, reader in ((g, jax_gmm.GMMDictionary), (ref, gmm.GMMDictionary)):
        path = tmp_path / f"gmm_{reader.__module__}.npz"
        writer.save(path)
        back = reader.load(path)
        for name in ("means", "covariances", "weights"):
            np.testing.assert_array_equal(getattr(back, name), getattr(writer, name))
        assert back.log_likelihood == writer.log_likelihood
        assert type(cli._load_dictionary(str(path))) is gmm.GMMDictionary


# --- get_gamma, exports, defaults ---------------------------------------------------


def test_get_gamma_matches_jax():
    """rtol 1e-5 against the JAX function (which computes its distances in
    float32 unless x64 is on) and against the closed formula in float64."""
    rng = np.random.default_rng(14)
    for k in (10, 200):
        centers = rng.standard_normal((k, 3))
        got = get_gamma(centers)
        np.testing.assert_allclose(got, jax_get_gamma(centers), rtol=1e-5)
        d = ((centers[:, None] - centers[None]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        np.testing.assert_allclose(got, 1.0 / (2.0 * d.min()), rtol=1e-10)
    assert isinstance(got, float)


def test_dictionary_exports_match_the_jax_package():
    from multi_modal_regression_tpu import dictionary as jax_dictionary

    assert sorted(dictionary.__all__) == sorted(jax_dictionary.__all__)
    for name in dictionary.__all__:
        assert hasattr(dictionary, name)


@pytest.mark.parametrize("fn", [
    kmeans.fit_kmeans, gmm.fit_gmm, kmeans.KMeansDictionary.predict,
    kmeans.KMeansDictionary.residuals, gmm.GMMDictionary.predict_proba,
    gmm.GMMDictionary.predict, gather_tree_poses, fit_pose_dictionary,
], ids=lambda f: f.__qualname__)
def test_dictionary_entry_points_default_to_the_card(fn):
    """Every entry point of the dictionary path runs on the card unless the
    caller asks for the CPU, as the tests do; so does `cli dictionary`."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_dictionary_defaults_to_the_card():
    args = cli.build_parser().parse_args(["dictionary", "--data-root", "x", "--out", "y"])
    assert args.device == "cuda" and args.type == "kmeans" and args.size == 200
    assert args.db_type == "render" and args.seed == 0 and args.fn is cli.cmd_dictionary


# --- naming, index, the tree, the CLI --------------------------------------------------


def _make_tree(root, rng, classes, per_class):
    """A tree of empty .png files named by make_name, as the render trees are."""
    eulers = {}
    for cls in classes:
        (root / cls).mkdir(parents=True)
        eulers[cls] = []
        for j in range(per_class):
            az, el, ct = rng.uniform(0, 360), rng.uniform(-30, 60), rng.uniform(-25, 25)
            name = make_name(f"{cls}_2008_{j:06d}object{j}", az, el, ct, 4.0)
            (root / cls / f"{name}.png").touch()
            eulers[cls].append((az, el, ct))
    return eulers


def test_naming_and_index_match_jax(tmp_path):
    rng = np.random.default_rng(15)
    name = make_name("car_n02690373_16object2", 30.5, -10.25, 20.0, 4.0)
    assert name == jax_make_name("car_n02690373_16object2", 30.5, -10.25, 20.0, 4.0)
    assert tuple(parse_name(name)) == tuple(jax_parse_name(name))
    assert parse_name(name).prefix == "car_n02690373_16object2"
    with pytest.raises(ValueError, match="cannot parse"):
        parse_name("car_x_e1_a2_t3_d4")
    classes = ("aeroplane", "car")
    _make_tree(tmp_path, rng, classes, 5)
    from multi_modal_regression_tpu.data.index import ClassBalancedIndex as JaxIndex

    port, ref = ClassBalancedIndex(str(tmp_path), "render", classes), JaxIndex(
        str(tmp_path), "render", classes)
    assert len(port) == len(ref) == 5
    for a, b in zip(port.list_image_names, ref.list_image_names):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.item_euler(3), ref.item_euler(3))
    assert port.item_paths_labels(2)[0] == ref.item_paths_labels(2)[0]
    port.shuffle(np.random.default_rng(1))
    ref.shuffle(np.random.default_rng(1))
    np.testing.assert_array_equal(port.item_euler(1), ref.item_euler(1))
    with pytest.raises(ValueError, match="real|render"):
        ClassBalancedIndex(str(tmp_path), "other", classes)
    with pytest.raises(FileNotFoundError, match="no index"):
        ClassBalancedIndex(str(tmp_path), "real", ("boat",))


@pytest.mark.parametrize("kind", ["kmeans", "gmm"])
def test_cli_dictionary_on_a_small_tree(tmp_path, capsys, kind):
    """`cli dictionary --device cpu` on a tree of 3 classes x 40 named files:
    the poses parsed equal the JAX gather_tree_poses (both tilt signs; atol
    1e-5, the tolerance of the euler_to_pose test: near 180 degrees the two
    libraries' float32 log maps differ by an ulp of pi), the printed lines are the JAX command's, and the file loads in
    the JAX package with the port's arrays."""
    rng = np.random.default_rng(16)
    tree = tmp_path / "render"
    _make_tree(tree, rng, cli.PASCAL3D_CLASSES[:3], 40)
    for db_type in ("render", "real"):
        got = gather_tree_poses(tree, db_type, cli.PASCAL3D_CLASSES[:3], device="cpu")
        want = jax_gather_tree_poses(tree, db_type, cli.PASCAL3D_CLASSES[:3])
        assert got.shape == (120, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)
    out = tmp_path / f"{kind}.npz"
    rc = cli.main(["dictionary", "--type", kind, "--data-root", str(tree), "--size", "6",
                   "--out", str(out), "--num-classes", "3", "--device", "cpu", "--seed", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "120 poses parsed"
    assert lines[1].startswith("kmeans fitted: inertia " if kind == "kmeans"
                               else "gmm fitted: log-likelihood ")
    assert lines[2] == f"saved {out} (6 atoms); reload OK"
    port = cli._load_dictionary(str(out))
    if kind == "kmeans":
        ref = jax_kmeans.KMeansDictionary.load(out)
        np.testing.assert_array_equal(ref.cluster_centers, port.cluster_centers)
        assert ref.cluster_centers.shape == (6, 3) and ref.inertia == port.inertia
        np.testing.assert_array_equal(ref.predict(got), port.predict(got, device="cpu"))
    else:
        ref = jax_gmm.GMMDictionary.load(out)
        np.testing.assert_array_equal(ref.means, port.means)
        np.testing.assert_array_equal(ref.covariances, port.covariances)
        assert ref.means.shape == (6, 3) and np.isfinite(ref.log_likelihood)
    assert cli._load_dictionary(None) is None


def test_cli_class_list_rules(tmp_path):
    """--num-classes N takes the first N PASCAL3D+ classes and refuses more
    than there are; --dbinfo names its own; fit_pose_dictionary writes a
    kmeans file and logs the pose count."""
    import scipy.io as spio

    parser = cli.build_parser()
    base = ["dictionary", "--data-root", "x", "--out", "y"]
    assert cli._classes_from_args(parser.parse_args(base)) == cli.PASCAL3D_CLASSES
    assert cli._classes_from_args(parser.parse_args(base + ["--num-classes", "2"])) == (
        "aeroplane", "bicycle")
    with pytest.raises(SystemExit, match="exceeds"):
        cli._classes_from_args(parser.parse_args(base + ["--num-classes", "13"]))
    spio.savemat(tmp_path / "dbinfo.mat", {"classes": np.array(["sofa", "train"], dtype=object)})
    args = parser.parse_args(base + ["--dbinfo", str(tmp_path / "dbinfo.mat")])
    assert cli._classes_from_args(args) == ("sofa", "train")
    _make_tree(tmp_path / "tree", np.random.default_rng(17), ("sofa", "train"), 12)
    logged = []
    fit_pose_dictionary(tmp_path / "tree", 3, tmp_path / "d.npz", classes=("sofa", "train"),
                        log=logged.append, device="cpu")
    assert logged == ["[dictionary] 24 poses; fitting kmeans K=3"]
    assert kmeans.KMeansDictionary.load(tmp_path / "d.npz").cluster_centers.shape == (3, 3)
