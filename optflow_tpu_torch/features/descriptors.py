"""Keypoint descriptors, fully batched for matrix-product matching.

- :func:`surf_descriptors` — SURF-class 64-dim float descriptor: a 4x4 grid
  of subregions over an oriented 20-sigma window, each accumulating
  (sum dx, sum |dx|, sum dy, sum |dy|) of scale-space gradients rotated into
  the keypoint frame, L2-normalized. (Replaces cv::cuda::SURF_CUDA's
  descriptor stage, src/features.cpp:86-87.)
- :func:`orb_descriptors` — ORB-class 256-bit binary descriptor from
  pairwise intensity tests on a smoothed patch, rotated by the keypoint
  orientation. The test pattern is generated from a fixed PRNG (BRIEF
  style) rather than OpenCV's learned table; descriptors are encoded as
  +/-1 float32 vectors so Hamming distance becomes a single matrix product:
  ham = (256 - a.b) / 2. (Replaces cv::cuda::ORB descriptors,
  src/features.cpp:58-61.)

Counterpart of the JAX package's ``features/descriptors.py``, with the same
sampling patterns (the BRIEF pattern is the same seeded numpy draw, so both
packages test the same pixel pairs). All sub-pixel sampling goes through
``features/patches.py``. The SURF path fuses orientation estimation and
description over ONE patch extraction (:func:`surf_orient_describe`).

Everything takes fixed-capacity Keypoints and returns (K, D) tensors — or
(F, K, D) for a stack of frames with (F, K) keypoints; invalid keypoints
get zero descriptors (matched out via masks downstream).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from optflow_tpu_torch.features.detect import (
    Keypoints,
    _batched,
    gaussian_blur,
    gaussian_gradients,
)
from optflow_tpu_torch.features.patches import extract_patches, sample_patches


def _batched_kps(kps: Keypoints, single: bool) -> Keypoints:
    return Keypoints(*(a[None] for a in kps)) if single else kps


# ------------------------------------------------------------ SURF-class

_GRID = 4  # 4x4 subregions
_SUB = 5  # 5x5 samples per subregion

# Patch geometry: 32x32 grid at 1.0-sigma spacing covers a 15.5-sigma
# radius — enough for the rotated 9.6-sigma descriptor window (13.6-sigma
# corner radius) and the 6-sigma orientation disk, bilinear support incl.
_P_SURF = 32
_STEP_SURF = 1.0


def _surf_sample_offsets():
    """(400, 2) sample offsets in units of sigma, spanning [-10, 10)."""
    n = _GRID * _SUB
    coords = (np.arange(n) - n / 2 + 0.5) * (20.0 / n)
    oy, ox = np.meshgrid(coords, coords, indexing="ij")
    return ox.reshape(-1).astype(np.float32), oy.reshape(-1).astype(np.float32)


_SURF_OX, _SURF_OY = _surf_sample_offsets()
# Gaussian weighting of samples (sigma 3.3 in sigma units, as in SURF).
_SURF_W = np.exp(
    -(_SURF_OX**2 + _SURF_OY**2) / (2 * 3.3**2)
).astype(np.float32)


# Orientation sampling pattern: disk of radius 6 (in sigma units).
def _orient_offsets():
    coords = np.arange(-6, 7, dtype=np.float32)
    oy, ox = np.meshgrid(coords, coords, indexing="ij")
    keep = ox**2 + oy**2 <= 36.0
    w = np.exp(-(ox**2 + oy**2) / (2 * 2.5**2))
    return (
        ox[keep].astype(np.float32),
        oy[keep].astype(np.float32),
        w[keep].astype(np.float32),
    )


_OR_OX, _OR_OY, _OR_W = _orient_offsets()


def _dev(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _surf_grad_patches(ims: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """(F, 2, K, P, P) sigma-normalized patches of (gx, gy) around each
    keypoint — the one extraction both orientation and description read."""
    gx, gy = gaussian_gradients(ims, 2.0)
    return extract_patches(
        torch.stack([gx, gy], dim=1), kps.x, kps.y, kps.sigma,
        _P_SURF, _STEP_SURF,
    )


def _orientations_from_patches(pats: torch.Tensor, kps: Keypoints):
    """Dominant gradient orientation per keypoint: the angle of the
    Gaussian-weighted mean gradient over a 6-sigma disk (the role of
    SURF's sliding-sector Haar voting, simplified to its first moment)."""
    c = (_P_SURF - 1) / 2.0
    shape = (*kps.x.shape, _OR_OX.size)
    px = (_dev(_OR_OX, pats) / _STEP_SURF + c).expand(shape)
    py = (_dev(_OR_OY, pats) / _STEP_SURF + c).expand(shape)
    dx = sample_patches(pats[:, 0], px, py)  # (F, K, S)
    dy = sample_patches(pats[:, 1], px, py)
    wgt = _dev(_OR_W, pats)
    angles = torch.atan2((dy * wgt).sum(dim=-1), (dx * wgt).sum(dim=-1))
    return torch.where(kps.valid, angles, torch.zeros_like(angles))


def _descriptors_from_patches(
    pats: torch.Tensor, kps: Keypoints, angles: torch.Tensor
) -> torch.Tensor:
    """(F, K, 64) L2-normalized descriptors from gradient patches."""
    ox = _dev(_SURF_OX, pats)
    oy = _dev(_SURF_OY, pats)
    wgt = _dev(_SURF_W, pats)
    ca = torch.cos(angles)[..., None]
    sa = torch.sin(angles)[..., None]
    cc = (_P_SURF - 1) / 2.0
    # rotate the sample grid into the (sigma-normalized) patch frame
    px = (ca * ox - sa * oy) / _STEP_SURF + cc  # (F, K, 400)
    py = (sa * ox + ca * oy) / _STEP_SURF + cc
    dx_i = sample_patches(pats[:, 0], px, py)
    dy_i = sample_patches(pats[:, 1], px, py)
    # rotate gradients into the keypoint frame
    dx = (ca * dx_i + sa * dy_i) * wgt
    dy = (-sa * dx_i + ca * dy_i) * wgt
    feats = torch.stack([dx, dx.abs(), dy, dy.abs()], dim=-1)
    # (F, K, 400, 4) -> (F, K, 4, 5, 4, 5, 4) -> sum over the 5x5 samples
    lead = feats.shape[:-2]
    feats = feats.reshape(*lead, _GRID, _SUB, _GRID, _SUB, 4)
    vec = feats.sum(dim=(-4, -2)).reshape(*lead, -1)  # (F, K, 64)
    norm = torch.sqrt((vec * vec).sum(dim=-1, keepdim=True) + 1e-8)
    desc = vec / norm
    return torch.where(kps.valid[..., None], desc, torch.zeros_like(desc))


def surf_orient_describe(
    im: torch.Tensor, kps: Keypoints, upright: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused SURF stage: one gradient-patch extraction feeding both the
    orientation estimate and the 64-dim descriptors. This is the production
    path (features/align.py uses it); the separate estimate_orientations /
    surf_descriptors wrappers below re-extract. Returns (angles, desc)."""
    ims, single = _batched(im)
    kps = _batched_kps(kps, single)
    with torch.no_grad():
        pats = _surf_grad_patches(ims, kps)
        if upright:
            angles = torch.zeros_like(kps.angle)
        else:
            angles = _orientations_from_patches(pats, kps)
        desc = _descriptors_from_patches(pats, kps, angles)
    return (angles[0], desc[0]) if single else (angles, desc)


def estimate_orientations(im: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    ims, single = _batched(im)
    kps = _batched_kps(kps, single)
    with torch.no_grad():
        angles = _orientations_from_patches(_surf_grad_patches(ims, kps), kps)
    return angles[0] if single else angles


def surf_descriptors(
    im: torch.Tensor, kps: Keypoints, upright: bool = False
) -> torch.Tensor:
    """64-dim L2-normalized SURF-class descriptors (uses kps.angle; pass
    upright=True to skip rotation)."""
    ims, single = _batched(im)
    kps = _batched_kps(kps, single)
    with torch.no_grad():
        pats = _surf_grad_patches(ims, kps)
        angles = torch.zeros_like(kps.angle) if upright else kps.angle
        desc = _descriptors_from_patches(pats, kps, angles)
    return desc[0] if single else desc


# ------------------------------------------------------------ ORB-class

_N_TESTS = 256

# 32x32 patch at 1.4-sigma spacing covers a 21.7-sigma radius: the BRIEF
# pattern clips at +/-14, so a rotated test point reaches 19.8 sigma.
_P_ORB = 32
_STEP_ORB = 1.4


def _brief_pattern(patch_size: int = 31, seed: int = 17):
    """BRIEF test-pair pattern: Gaussian-distributed point pairs inside the
    patch, fixed seed for determinism across runs/processes."""
    rng = np.random.default_rng(seed)
    std = patch_size / 5.0
    lim = patch_size // 2 - 1
    pts = np.clip(
        rng.normal(0.0, std, size=(_N_TESTS, 4)), -lim, lim
    ).astype(np.float32)
    return pts  # columns: x1, y1, x2, y2


_BRIEF = _brief_pattern()


def orb_descriptors(im: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """256-dim +/-1 float32 binary descriptors (rotated BRIEF tests)."""
    ims, single = _batched(im)
    kps = _batched_kps(kps, single)
    with torch.no_grad():
        blurred = gaussian_blur(ims, 2.0)
        pat = _dev(_BRIEF, blurred)
        pats = extract_patches(
            blurred[:, None], kps.x, kps.y, kps.sigma, _P_ORB, _STEP_ORB
        )[:, 0]  # (F, K, P, P)

        ca = torch.cos(kps.angle)[..., None]
        sa = torch.sin(kps.angle)[..., None]
        cc = (_P_ORB - 1) / 2.0
        # both test points of all 256 pairs, rotated into the patch frame
        x1 = (ca * pat[:, 0] - sa * pat[:, 1]) / _STEP_ORB + cc  # (F, K, 256)
        y1 = (sa * pat[:, 0] + ca * pat[:, 1]) / _STEP_ORB + cc
        x2 = (ca * pat[:, 2] - sa * pat[:, 3]) / _STEP_ORB + cc
        y2 = (sa * pat[:, 2] + ca * pat[:, 3]) / _STEP_ORB + cc
        v = sample_patches(
            pats, torch.cat([x1, x2], dim=-1), torch.cat([y1, y2], dim=-1)
        )  # (F, K, 512)
        v1, v2 = v[..., :_N_TESTS], v[..., _N_TESTS:]
        desc = torch.where(v1 < v2, 1.0, -1.0)
        desc = torch.where(kps.valid[..., None], desc, torch.zeros_like(desc))
    return desc[0] if single else desc
