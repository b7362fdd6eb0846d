"""The port's feature pre-alignment against the JAX package's, module by
module and end to end, on the same numpy inputs, on the CPU.

Frames are at most 128 x 256, capacities 256, 64-128 RANSAC hypotheses.
Keypoints, descriptors and parameters go from one package to the other
through ``optflow_tpu_torch.convert`` (numpy in between)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optflow_tpu.core import config as jcfg
from optflow_tpu.features import align as jalign
from optflow_tpu.features import descriptors as jdesc
from optflow_tpu.features import detect as jdet
from optflow_tpu.features import match as jmatch
from optflow_tpu.features import patches as jpatch
from optflow_tpu.features import ransac as jransac
from optflow_tpu_torch import convert
from optflow_tpu_torch.features import align as talign
from optflow_tpu_torch.features import descriptors as tdesc
from optflow_tpu_torch.features import detect as tdet
from optflow_tpu_torch.features import match as tmatch
from optflow_tpu_torch.features import patches as tpatch
from optflow_tpu_torch.features import ransac as transac
from tests.conftest import make_fibsem_like
from tests.test_features import _affine_warp_np

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

H, W = 128, 256
IDENTITY = np.array([[1, 0, 0], [0, 1, 0]], np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _frame(seed, h=H, w=W, smooth=5):
    return make_fibsem_like(np.random.default_rng(seed), h, w, smooth=smooth)


def _valid_set(kps):
    """(M, 3) array of the valid keypoints' (x, y, sigma), and responses."""
    x, y, sigma, _angle, resp, valid = (np.asarray(a) for a in kps)
    return np.stack([x, y, sigma], 1)[valid], resp[valid]


def _found_share(a, b, tol=0.5):
    """Share of a's keypoints with one of b within ``tol`` px and of the
    same scale."""
    if len(a) == 0:
        return 1.0
    d = np.abs(a[:, None, :2] - b[None, :, :2]).max(-1)
    same_scale = np.abs(a[:, None, 2] - b[None, :, 2]) <= 1e-3 * a[:, None, 2]
    return float(((d <= tol) & same_scale).any(1).mean())


def _jax_keypoints_to_port(kps):
    return convert.keypoints_from_numpy(
        *(np.asarray(a) for a in kps), device="cpu")


# ----------------------------------------------------------------- patches


def test_extract_patches_within_bf16_weight_error():
    """The JAX module samples with bfloat16 hat-weight matrix products, the
    port gathers in float32: 2e-2 of the image's range (0-255), no more."""
    im = _frame(1)
    rng = np.random.default_rng(2)
    k = 40
    x = rng.uniform(5, W - 5, k).astype(np.float32)
    y = rng.uniform(5, H - 5, k).astype(np.float32)
    s = rng.uniform(1.0, 3.0, k).astype(np.float32)
    ims = np.stack([im, im[::-1].copy()])
    want = np.asarray(jpatch.extract_patches(
        jnp.asarray(ims), jnp.asarray(x), jnp.asarray(y), jnp.asarray(s),
        16, 1.0))
    got = tpatch.extract_patches(_t(ims), _t(x), _t(y), _t(s), 16, 1.0)
    assert got.shape == want.shape == (2, k, 16, 16)
    assert np.abs(got.numpy() - want).max() <= 2e-2 * 255.0
    # against the exact function: the float32 formulation of the JAX module
    exact = np.asarray(jpatch.extract_patches(
        jnp.asarray(ims), jnp.asarray(x), jnp.asarray(y), jnp.asarray(s),
        16, 1.0, dtype=jnp.float32))
    assert np.abs(got.numpy() - exact).max() <= 2e-3
    # a stack of frames with per-frame keypoints is the same function
    both = tpatch.extract_patches(
        _t(ims)[:, None], _t(np.stack([x, x])), _t(np.stack([y, y])),
        _t(np.stack([s, s])), 16, 1.0)
    assert both.shape == (2, 1, k, 16, 16)
    assert torch.equal(both[:, 0], got)


def test_sample_patches_within_bf16_weight_error():
    rng = np.random.default_rng(3)
    pats = rng.uniform(0, 255, (30, 16, 16)).astype(np.float32)
    px = rng.uniform(-1, 16, (30, 25)).astype(np.float32)  # rim: clamped
    py = rng.uniform(-1, 16, (30, 25)).astype(np.float32)
    want = np.asarray(jpatch.sample_patches(
        jnp.asarray(pats), jnp.asarray(px), jnp.asarray(py)))
    exact = np.asarray(jpatch.sample_patches(
        jnp.asarray(pats), jnp.asarray(px), jnp.asarray(py),
        dtype=jnp.float32))
    got = tpatch.sample_patches(_t(pats), _t(px), _t(py)).numpy()
    assert np.abs(got - want).max() <= 2e-2 * 255.0
    assert np.abs(got - exact).max() <= 2e-3


# --------------------------------------------------------------- detectors


@pytest.fixture(scope="module")
def hessian_pair():
    im = _frame(4)
    want = jdet.hessian_keypoints(
        jnp.asarray(im), hessian_threshold=30.0, capacity=256)
    got = tdet.hessian_keypoints(_t(im), hessian_threshold=30.0, capacity=256)
    return im, want, got


def test_hessian_keypoints_agree_as_sets(hessian_pair):
    """>= 95 % of either package's valid keypoints are found by the other
    within 0.5 px at the same scale; slots are not compared (top_k orders
    ties differently) and responses of the common ones agree to 1e-3."""
    _im, want, got = hessian_pair
    a, ra = _valid_set(want)
    b, rb = _valid_set(got)
    assert len(a) >= 60 and abs(len(a) - len(b)) <= 0.05 * len(a)
    assert _found_share(a, b) >= 0.95 and _found_share(b, a) >= 0.95
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    i, j = np.nonzero(d <= 1e-3)
    assert len(i) >= 0.9 * len(a)
    assert np.abs(ra[i] - rb[j]).max() <= 1e-3 * np.abs(ra[i]).max()


def test_hessian_keypoints_of_a_stack_equal_each_frames_own():
    ims = np.stack([_frame(5), _frame(6)])
    both = tdet.hessian_keypoints(_t(ims), hessian_threshold=30.0, capacity=128)
    assert both.x.shape == (2, 128)
    for f in range(2):
        one = tdet.hessian_keypoints(
            _t(ims[f]), hessian_threshold=30.0, capacity=128)
        a, _ = _valid_set(one)
        b, _ = _valid_set(tdet.Keypoints(*(t[f] for t in both)))
        assert _found_share(a, b, 0.01) == 1.0 == _found_share(b, a, 0.01)


def test_fast_keypoints_agree_as_sets():
    im = _frame(7, smooth=3)
    kw = dict(fast_threshold=8.0, nlevels=4, capacity=256, edge_threshold=16)
    want = jdet.fast_keypoints(jnp.asarray(im), **kw)
    got = tdet.fast_keypoints(_t(im), **kw)
    a, _ = _valid_set(want)
    b, _ = _valid_set(got)
    assert len(a) >= 40
    assert _found_share(a, b) >= 0.95 and _found_share(b, a) >= 0.95
    # the orientation of the common corners: integral centres make the JAX
    # side's weights exact, but it rounds the image itself to bfloat16
    ang_a = np.asarray(want.angle)[np.asarray(want.valid)]
    ang_b = got.angle.numpy()[got.valid.numpy()]
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    i, j = np.nonzero(d <= 1e-3)
    diff = np.abs(np.angle(np.exp(1j * (ang_a[i] - ang_b[j]))))
    assert len(i) >= 0.9 * len(a) and np.quantile(diff, 0.95) <= 0.02


def test_a_flat_frame_has_no_keypoints():
    flat = torch.full((96, 128), 90.0)
    assert not bool(tdet.hessian_keypoints(flat, capacity=64).valid.any())
    assert not bool(tdet.fast_keypoints(
        flat, capacity=64, nlevels=2, edge_threshold=16).valid.any())


# ------------------------------------------------------------- descriptors


def test_surf_descriptors_on_the_same_keypoints(hessian_pair):
    """Orientation and descriptors of the JAX package's keypoints by both
    packages: cosine >= 0.99 for every valid keypoint (the JAX side carries
    bfloat16 sampling weights), angles within 0.05 rad for 95 %."""
    im, kps, _ = hessian_pair
    want_a, want_d = jdesc.surf_orient_describe(jnp.asarray(im), kps)
    got_a, got_d = tdesc.surf_orient_describe(
        _t(im), _jax_keypoints_to_port(kps))
    valid = np.asarray(kps.valid)
    want_d, got_d = np.asarray(want_d), got_d.numpy()
    assert got_d.shape == want_d.shape == (256, 64)
    cos = (want_d * got_d).sum(1)[valid]
    assert cos.min() >= 0.99
    assert not got_d[~valid].any()
    da = np.abs(np.angle(np.exp(1j * (np.asarray(want_a) - got_a.numpy()))))
    assert np.quantile(da[valid], 0.95) <= 0.05
    # the separate entry points re-extract and agree with the fused one
    kp = _jax_keypoints_to_port(kps)._replace(angle=got_a)
    assert torch.allclose(tdesc.surf_descriptors(_t(im), kp), _t(got_d),
                          atol=1e-6)
    assert torch.allclose(tdesc.estimate_orientations(_t(im), kp), got_a,
                          atol=1e-6)


def test_estimate_orientations_of_a_ramp():
    """A pure intensity ramp has gradient direction = ramp direction."""
    ys, xs = np.mgrid[0:64, 0:64].astype(np.float32)
    th = np.deg2rad(30.0)
    im = np.cos(th) * xs + np.sin(th) * ys
    kps = convert.keypoints_from_numpy(
        [32.0], [32.0], [2.0], [0.0], [1.0], [True], device="cpu")
    ang = float(tdesc.estimate_orientations(_t(im), kps)[0])
    assert abs(ang - th) < 0.05


def test_orb_descriptors_on_the_same_keypoints():
    """<= 8 of 256 bits differ per keypoint for 95 % of the valid keypoints
    (a bit flips where the two intensities of its test are within the JAX
    side's bfloat16 sampling error), and the test pattern is the same."""
    assert np.array_equal(tdesc._BRIEF, jdesc._BRIEF)
    im = _frame(8, smooth=3)
    kps = jdet.fast_keypoints(
        jnp.asarray(im), fast_threshold=8.0, nlevels=4, capacity=256,
        edge_threshold=16)
    want = np.asarray(jdesc.orb_descriptors(jnp.asarray(im), kps))
    got = tdesc.orb_descriptors(_t(im), _jax_keypoints_to_port(kps)).numpy()
    valid = np.asarray(kps.valid)
    assert set(np.unique(got[valid])) <= {-1.0, 1.0} and not got[~valid].any()
    flipped = (want != got).sum(1)[valid]
    assert np.quantile(flipped, 0.95) <= 8 and flipped.mean() <= 4


# ---------------------------------------------------------------- matching


@pytest.mark.parametrize("binary", [False, True])
def test_knn_match2_on_the_same_descriptors(binary):
    """Identical best-match indices wherever the JAX margin between best and
    second exceeds 1e-3; distances within 1e-5; the same ratio mask away
    from the ratio's edge."""
    rng = np.random.default_rng(9)
    k0, k1, d = 120, 140, 64
    d1 = rng.standard_normal((k1, d)).astype(np.float32)
    d0 = d1[rng.permutation(k1)[:k0]] + 0.15 * rng.standard_normal(
        (k0, d)).astype(np.float32)
    if binary:
        d0, d1 = np.sign(d0), np.sign(d1)
    else:
        d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
        d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    v0 = rng.uniform(size=k0) > 0.1
    v1 = rng.uniform(size=k1) > 0.1
    want = jmatch.knn_match2(jnp.asarray(d0), jnp.asarray(v0),
                             jnp.asarray(d1), jnp.asarray(v1), binary=binary)
    got = tmatch.knn_match2(_t(d0), torch.from_numpy(v0), _t(d1),
                            torch.from_numpy(v1), binary=binary)
    w1, w2 = np.asarray(want.dist1), np.asarray(want.dist2)
    valid = np.asarray(want.valid)
    assert np.array_equal(got.valid.numpy(), valid)
    clear = valid & (w2 - w1 > 1e-3)
    assert clear.sum() >= 0.8 * valid.sum()
    assert np.array_equal(got.idx.numpy()[clear], np.asarray(want.idx)[clear])
    assert np.abs(got.dist1.numpy()[valid] - w1[valid]).max() <= 1e-5 * d
    assert np.abs(got.dist2.numpy()[valid] - w2[valid]).max() <= 1e-5 * d
    assert np.isinf(got.dist1.numpy()[~valid]).all()
    edge = np.abs(w1 - 0.8 * w2) <= 1e-4
    same = tmatch.ratio_filter(got, 0.8).numpy() == np.asarray(
        jmatch.ratio_filter(want, 0.8))
    assert same[~edge | ~valid].all()
    # a batch of pairs is the same function
    two = tmatch.knn_match2(_t(d0)[None], torch.from_numpy(v0)[None],
                            _t(d1)[None], torch.from_numpy(v1)[None],
                            binary=binary)
    assert torch.equal(two.idx[0], got.idx)


# ------------------------------------------------------------------ RANSAC


def _correspondences(seed, k=90, outliers=25):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, 250, (k, 2))
    th = np.deg2rad(2.0)
    Ht = np.array([[np.cos(th), -np.sin(th), 4.0],
                   [np.sin(th), np.cos(th), -3.0], [2e-5, -1e-5, 1.0]])
    q = np.c_[p0, np.ones(k)] @ Ht.T
    p1 = q[:, :2] / q[:, 2:] + rng.normal(0, 0.3, (k, 2))
    p1[:outliers] += rng.uniform(-60, 60, (outliers, 2))
    mask = np.ones(k, bool)
    mask[-8:] = False
    p1[-8:] = 0.0
    return p0.astype(np.float32), p1.astype(np.float32), mask, Ht


def _jax_samples(mask, n_hyp, seed=0):
    """The hypotheses the JAX package draws for this mask
    (features/ransac.py: jax.random.choice over the masked points)."""
    maskf = jnp.asarray(mask, jnp.float32)
    probs = maskf / jnp.maximum(jnp.sum(maskf), 1.0)
    return np.asarray(jax.random.choice(
        jax.random.PRNGKey(seed), mask.shape[0], shape=(n_hyp, 4),
        replace=True, p=probs))


@pytest.mark.parametrize("method", [0, 4, 8])
def test_find_homography_with_the_jax_packages_hypotheses(method):
    """The same hypotheses in (drawn by the JAX package's own call): H
    within 1e-3 of its largest entry, the same verdict, the same inliers
    except points within 1e-3 px of the threshold."""
    p0, p1, mask, Ht = _correspondences(10 + method)
    thresh, n_hyp = 3.0, 96
    want = jransac.find_homography(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask), thresh=thresh,
        method=method, n_hypotheses=n_hyp)
    samples = torch.from_numpy(_jax_samples(mask, n_hyp))
    got = transac.find_homography(
        _t(p0), _t(p1), torch.from_numpy(mask), thresh=thresh, method=method,
        samples=samples)
    Hw = np.asarray(want.H)
    assert bool(got.ok) == bool(want.ok) is True
    assert np.abs(got.H.numpy() - Hw).max() <= 1e-3 * np.abs(Hw).max()
    proj = np.c_[p0, np.ones(len(p0))] @ Hw.T
    r = np.hypot(*(proj[:, :2] / proj[:, 2:] - p1).T)
    away = np.abs(r - thresh) > 1e-3
    assert np.array_equal(got.inliers.numpy()[away],
                          np.asarray(want.inliers)[away])
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= (~away).sum()
    if method != 0:
        assert np.abs(got.H.numpy() - Ht).max() <= 0.5  # and near the truth


def test_find_homography_draws_its_own_hypotheses_reproducibly():
    p0, p1, mask, Ht = _correspondences(21)
    args = (_t(p0), _t(p1), torch.from_numpy(mask))
    a = transac.find_homography(*args, thresh=3.0, n_hypotheses=128)
    b = transac.find_homography(*args, thresh=3.0, n_hypotheses=128)
    c = transac.find_homography(
        *args, thresh=3.0, n_hypotheses=128,
        generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.H, b.H) and bool(a.ok) and bool(c.ok)
    assert np.abs(a.H.numpy() - Ht).max() <= 0.5
    assert np.abs(c.H.numpy() - Ht).max() <= 0.5
    idx = transac.draw_samples(torch.from_numpy(mask), 64)
    assert idx.shape == (64, 4) and bool(torch.from_numpy(mask)[idx].all())
    # a batch of pairs, one of them with no valid correspondence at all
    none = np.zeros_like(mask)
    two = transac.find_homography(
        _t(np.stack([p0, p0])), _t(np.stack([p1, p1])),
        torch.from_numpy(np.stack([mask, none])), thresh=3.0, n_hypotheses=64)
    assert two.ok.tolist() == [True, False] and two.H.shape == (2, 3, 3)


def test_degenerate_samples_do_not_raise():
    """Four times the same point, and collinear points: no exception, no
    accepted model."""
    p = np.zeros((12, 2), np.float32)
    p[:, 0] = np.arange(12)
    mask = torch.ones(12, dtype=torch.bool)
    res = transac.find_homography(_t(p), _t(p * 2), mask, n_hypotheses=32)
    assert res.H.shape == (3, 3)
    same = torch.zeros(16, 4, dtype=torch.int64)
    res = transac.find_homography(_t(p), _t(p), mask, samples=same)
    assert res.inliers.shape == (12,)


def test_median_averages_the_two_middle_values():
    r = torch.tensor([[4.0, 1.0, 3.0, 2.0, 9.0]])
    mask = torch.tensor([True, True, True, True, False])
    assert transac._median_of_valid(r, mask).tolist() == [2.5]
    assert float(np.nanmedian([4.0, 1.0, 3.0, 2.0, np.nan])) == 2.5
    none = torch.zeros(5, dtype=torch.bool)
    assert torch.isinf(transac._median_of_valid(r, none)).all()


# ---------------------------------------------------------- find_alignment

ALIGN_ARGS = {"hessianThreshold": 30, "ratio": 0.85, "debug": False}


def _corner_distance(a, b, h, w):
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                        [w - 1, h - 1, 1]], np.float64).T
    return float(np.abs(np.asarray(a, np.float64) @ corners
                        - np.asarray(b, np.float64) @ corners).max())


def _rotation(deg, tx, ty, cx, cy):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, cx - c * cx + s * cy + tx],
                     [s, c, cy - s * cx - c * cy + ty]])


ALIGN_CASES = {
    "translation": (np.array([[1.0, 0, 6.0], [0, 1.0, -4.0]]), {}, False),
    "small_rotation": (_rotation(3.0, 5.0, 2.0, 0, 0), {}, False),
    "zoom_rejected": (np.array([[1.5, 0, 0], [0, 1.5, 0.0]]), {}, True),
    "orb": (np.array([[1.0, 0, 5.0], [0, 1.0, 3.0]]), {"features": 1}, False),
}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_find_alignment_agrees_with_the_jax_package(case):
    """The cases of the JAX package's own tests: both packages take the same
    gate decision, recover the motion, and their affines lie within 1.0 px
    of each other at the frame's corners (their RANSAC hypotheses differ)."""
    A, extra, identity = ALIGN_CASES[case]
    im0 = _frame(30, 160, 160)
    im1 = _affine_warp_np(im0, A)
    args = {**ALIGN_ARGS, **extra}
    want = jalign.find_alignment(im1, im0, {}, dict(args))
    got = talign.find_alignment(im1, im0, {}, dict(args), device="cpu")
    assert got.shape == (2, 3) and got.dtype == np.float32
    assert np.allclose(want, IDENTITY, atol=1e-6) == identity
    assert np.allclose(got, IDENTITY, atol=1e-6) == identity
    if identity:
        return
    Ainv = np.linalg.inv(np.vstack([A, [0, 0, 1]]))[:2]
    assert np.allclose(got[:, :2], Ainv[:, :2], atol=0.05), got
    assert np.allclose(got[:, 2], Ainv[:, 2], atol=3.0), got
    assert _corner_distance(got, want, 160, 160) <= (3.0 if extra else 1.0)


def test_find_alignment_not_enough_matches(capsys):
    flat = np.zeros((96, 96), np.float32)
    want = jalign.find_alignment(flat, flat, {}, dict(ALIGN_ARGS))
    said = capsys.readouterr().out
    got = talign.find_alignment(flat, flat, {}, dict(ALIGN_ARGS), device="cpu")
    assert np.array_equal(got, want) and np.array_equal(got, IDENTITY)
    assert capsys.readouterr().out == said
    assert "Not enough matches. Using no transformation" in said


def test_align_warnings_are_the_reference_messages(capsys):
    H = np.eye(3)
    for enough, ok in ((False, True), (True, False), (True, True)):
        talign.print_align_warnings(enough, ok, H, True)
        mine = capsys.readouterr().out
        jalign.print_align_warnings(enough, ok, H, True)
        assert capsys.readouterr().out == mine


def test_feature_parameters_resolve_alike():
    args = jcfg.load_job("docs/example.json")
    for im in ({}, {"features": 1, "ratio": 0.7, "hessianThreshold": 1600,
                    "nfeatures": 900}, {"homo": 8, "ransac": 2.5}):
        want = jalign.resolve_feature_params(im, args)
        got = talign.resolve_feature_params(im, args)
        assert got == convert.feature_params_from_reference(
            want[0], *(dataclasses.asdict(p) for p in want[1:]))
        for h, w in ((256, 1024), (128, 256), (64, 64)):
            assert talign._detect_capacity(got[0], h, w, got[1], got[2]) == \
                jalign._detect_capacity(want[0], h, w, want[1], want[2])
    with pytest.raises(ValueError, match="fields differ"):
        convert.feature_params_from_reference(2, {}, {}, {})


def test_capacity_clamp_is_kept_and_logged(caplog):
    import logging

    surf, orb = talign.SurfParams(), talign.OrbParams()
    with caplog.at_level(logging.INFO, logger=talign.__name__):
        assert talign._detect_capacity(2, 256, 1024, orb, surf) == 1536
    assert "clamped to 1536" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=talign.__name__):
        assert talign._detect_capacity(2, 128, 256, orb, surf) == 327
    assert caplog.text == ""


def test_indexed_alignment_equals_the_pairwise_one():
    """Detect once per unique frame, match per pair: the same affines as the
    pair-by-pair pipeline on the same three frames."""
    im0 = _frame(31)
    frames = np.stack([
        im0, _affine_warp_np(im0, np.array([[1.0, 0, 4.0], [0, 1.0, -2.0]])),
        _affine_warp_np(im0, _rotation(1.0, -3.0, 2.0, W / 2, H / 2))])
    ftype, orb, surf, mp = talign.resolve_feature_params({}, ALIGN_ARGS)
    src = torch.tensor([1, 2, 2])
    dst = torch.tensor([0, 0, 1])
    res = talign.find_alignment_indexed(
        _t(frames), src, dst, ftype, orb, surf, mp)
    pairwise = talign.find_alignment_batched_device(
        _t(frames)[src], _t(frames)[dst], ftype, orb, surf, mp)
    assert res.affine.shape == (3, 2, 3)
    assert bool(res.enough.all()) and bool(res.homo_ok.all())
    assert torch.allclose(res.affine, pairwise.affine, atol=1e-5)
    one = talign.find_alignment_device(
        _t(frames[2]), _t(frames[1]), ftype, orb, surf, mp)
    assert torch.allclose(one.affine, res.affine[2], atol=1e-5)
    want = jalign.find_alignment(frames[1], frames[0], {}, dict(ALIGN_ARGS))
    assert _corner_distance(res.affine[0].numpy(), want, H, W) <= 1.0


def test_keypoints_and_affines_cross_between_the_packages(hessian_pair):
    """convert carries keypoints and affines across as numpy: fields, order,
    dtypes and values survive both ways."""
    _im, kps, _ = hessian_pair
    mine = _jax_keypoints_to_port(kps)
    assert mine._fields == kps._fields
    back = convert.keypoints_to_numpy(mine)
    for a, b in zip(back, kps):
        assert np.array_equal(a, np.asarray(b)) and a.dtype == np.asarray(b).dtype
    with pytest.raises(ValueError, match="shape"):
        convert.keypoints_from_numpy([1.0], [1.0, 2.0], [1.0], [0.0], [1.0],
                                     [True], device="cpu")
    aff = convert.affine_from_numpy(np.stack([IDENTITY, 2 * IDENTITY]), "cpu")
    assert aff.shape == (2, 2, 3) and aff.dtype == torch.float32
    with pytest.raises(ValueError, match=r"\(2, 3\)"):
        convert.affine_from_numpy(np.eye(3), "cpu")
