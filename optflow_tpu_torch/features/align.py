"""Feature-based pre-alignment: find_alignment.

Implements the reference's find_alignment (src/features.cpp:46-167):
detect + describe on both frames (ORB-class for ``features == 1``,
SURF-class for ``features == 2``, default SURF), k=2 brute-force matching,
Lowe ratio test, homography estimation by the configured ``homo`` method
with ``ransac`` reprojection threshold, then the sanity gates:

- fewer than 11 good matches -> identity + "Not enough matches"
  (src/features.cpp:157-166)
- no homography or either diagonal scale term deviating more than 20%
  from 1 -> identity + warning (src/features.cpp:134-147)
- otherwise the affine is the top two rows of the homography
  (src/features.cpp:154) — the projective row is dropped, as in the
  reference.

The returned 2x3 affine maps the first argument's coordinates into the
second argument's space (the engine calls find_alignment(frame1, frame0),
src/optflow.cpp:373, then warps frame1 with it).

Counterpart of the JAX package's ``features/align.py``. The whole pipeline —
detection, description, matching, RANSAC, sanity gates — runs on the tensors'
device with the gates applied there (identity selected with
``torch.where``), so a pair, or a whole group of pairs, costs a single host
readback. :func:`find_alignment_indexed` is the batched job runner's entry:
detect + describe once per unique frame, match + fit per pair.

The reference's SURF pad-to-multiple-of-64 workaround
(src/features.cpp:70-78) is a CUDA-SURF implementation detail and is not
needed here.
"""

from __future__ import annotations

import logging
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from optflow_tpu_torch.core.config import (
    MatchParams,
    OrbParams,
    SurfParams,
    feature_type,
    ORB_TYPE,
)
from optflow_tpu_torch.features.descriptors import (
    orb_descriptors,
    surf_orient_describe,
)
from optflow_tpu_torch.features.detect import (
    Keypoints,
    fast_keypoints,
    hessian_keypoints,
)
from optflow_tpu_torch.features.match import knn_match2, ratio_filter
from optflow_tpu_torch.features.ransac import HomographyResult, find_homography

IDENTITY = np.array([[1.0, 0, 0], [0, 1.0, 0]], dtype=np.float32)

# Upper clamp of the SURF-class detector's capacity.
SURF_CAPACITY_MAX = 1536

_log = logging.getLogger(__name__)


class AlignResult(NamedTuple):
    """Device-side alignment outcome for one pair, or with a leading axis
    for a batch of pairs."""

    affine: torch.Tensor  # (2, 3) f32 — identity when any gate fired
    n_good: torch.Tensor  # () i32 ratio-test survivors
    enough: torch.Tensor  # () bool  n_good > 10 (src/features.cpp:130)
    homo_ok: torch.Tensor  # () bool homography found & zoom gate passed
    H: torch.Tensor  # (3, 3) raw homography (for debug prints)


def _detect_capacity(ftype: int, h: int, w: int, orb: OrbParams, surf: SurfParams) -> int:
    if ftype == ORB_TYPE:
        return min(max(int(orb.nfeatures), 64), 2048)
    # The reference bounds its keypoint buffer by keypointsRatio * pixels
    # (src/features.cpp:34-44). Descriptor cost is linear in the capacity
    # (fixed shapes), so it is clamped: keypoints remain the top-K by
    # response, and an extremely dense image loses only its weakest
    # detections. The clamp is logged where it binds.
    wanted = surf.keypoints_ratio * h * w
    if wanted > SURF_CAPACITY_MAX:
        _log.info(
            "detector capacity clamped to %d (keypointsRatio %g x %d x %d "
            "pixels asks for %d)", SURF_CAPACITY_MAX, surf.keypoints_ratio,
            h, w, int(wanted),
        )
    return int(np.clip(wanted, 256, SURF_CAPACITY_MAX))


def _detect_describe_device(
    ims: torch.Tensor, ftype: int, orb: OrbParams, surf: SurfParams
) -> Tuple[Keypoints, torch.Tensor, bool]:
    """Keypoints and descriptors of one ``(H, W)`` frame or of every frame
    of an ``(F, H, W)`` stack, and whether the descriptors are binary."""
    h, w = ims.shape[-2:]
    cap = _detect_capacity(ftype, h, w, orb, surf)
    if ftype == ORB_TYPE:
        kps = fast_keypoints(
            ims,
            fast_threshold=orb.fast_threshold,
            scale_factor=orb.scale_factor,
            nlevels=orb.nlevels,
            capacity=cap,
            edge_threshold=orb.edge_threshold,
        )
        return kps, orb_descriptors(ims, kps), True
    kps = hessian_keypoints(
        ims,
        hessian_threshold=surf.hessian_threshold,
        n_octaves=surf.n_octaves,
        n_octave_layers=surf.n_octave_layers,
        capacity=cap,
    )
    # fused: one gradient-patch extraction feeds orientation + descriptors
    angles, desc = surf_orient_describe(ims, kps, upright=surf.upright)
    return kps._replace(angle=angles), desc, False


def _match_and_fit(
    kps0: Keypoints,
    desc0: torch.Tensor,
    kps1: Keypoints,
    desc1: torch.Tensor,
    binary: bool,
    mp: MatchParams,
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> AlignResult:
    """Per-pair half of the alignment: k=2 matching, ratio test, RANSAC
    homography and the reference's sanity gates, on precomputed
    keypoints/descriptors of one pair or of a batch of pairs."""
    with torch.no_grad():
        matches = knn_match2(desc0, kps0.valid, desc1, kps1.valid, binary=binary)
        good = ratio_filter(matches, mp.ratio)
        p0, p1 = matched_points(kps0, kps1, matches.idx)
        res = find_homography(
            p0, p1, good, thresh=float(mp.ransac), method=int(mp.homo),
            generator=generator, samples=samples,
        )
    return gate_homography(res, good, mp)


def matched_points(
    kps0: Keypoints, kps1: Keypoints, idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p0, p1), ``(..., K, 2)``: every keypoint of set 0 and its best match
    ``idx`` in set 1 (``Knn2.idx``)."""
    p0 = torch.stack([kps0.x, kps0.y], dim=-1)
    p1 = torch.stack([
        torch.gather(kps1.x, -1, idx),
        torch.gather(kps1.y, -1, idx),
    ], dim=-1)
    return p0, p1


def gate_homography(
    res: HomographyResult, good: torch.Tensor, mp: MatchParams
) -> AlignResult:
    """The reference's sanity gates on a homography fitted to the ``good``
    matches (the ratio test's mask): its top two rows as the affine, or the
    identity where too few matches survived or the fit failed the zoom
    gate."""
    with torch.no_grad():
        n_good = good.sum(dim=-1).to(torch.int32)
        enough = n_good > 10  # src/features.cpp:130
        H = res.H
        zoom_ok = (
            ((1.0 - H[..., 0, 0]).abs() <= mp.max_zoom_deviation)
            & ((1.0 - H[..., 1, 1]).abs() <= mp.max_zoom_deviation)
        )  # src/features.cpp:134-147
        homo_ok = res.ok & zoom_ok & torch.isfinite(H).all(dim=-1).all(dim=-1)

        use = (enough & homo_ok)[..., None, None]
        identity = torch.as_tensor(IDENTITY, device=H.device)
        affine = torch.where(use, H[..., 0:2, 0:3], identity).to(torch.float32)
    return AlignResult(affine, n_good, enough, homo_ok, H)


def find_alignment_device(
    src: torch.Tensor,  # (H, W) frame whose coords the affine maps FROM
    dst: torch.Tensor,  # (H', W') target coordinate space
    ftype: int,
    orb: OrbParams,
    surf: SurfParams,
    mp: MatchParams,
    generator: Optional[torch.Generator] = None,
) -> AlignResult:
    """Whole alignment pipeline of one pair on the tensors' device; no host
    syncs. The two frames may differ in size."""
    kps0, desc0, binary = _detect_describe_device(src, ftype, orb, surf)
    kps1, desc1, _ = _detect_describe_device(dst, ftype, orb, surf)
    return _match_and_fit(kps0, desc0, kps1, desc1, binary, mp, generator)


def find_alignment_indexed(
    frames: torch.Tensor,  # (F, H, W) UNIQUE frames
    src_idx: torch.Tensor,  # (N,) int64 — frame whose coords map FROM
    dst_idx: torch.Tensor,  # (N,) int64 — target coordinate space
    ftype: int,
    orb: OrbParams,
    surf: SurfParams,
    mp: MatchParams,
    generator: Optional[torch.Generator] = None,
) -> AlignResult:
    """Frame-deduplicated batched alignment: detect + describe run ONCE
    per unique frame, matching + RANSAC per pair. Production pair lists
    chain sections (z-distance <= 3 graphs reuse every frame in up to 6
    pairs, support_scripts/gen_cross_file_list.py), so this halves-plus
    the dominant detect/describe cost vs the per-pair pipeline."""
    kps, desc, binary = _detect_describe_device(frames, ftype, orb, surf)
    return match_and_fit_indexed(
        kps, desc, src_idx, dst_idx, binary, mp, generator
    )


def match_and_fit_indexed(
    kps: Keypoints,  # (F, K) fields
    desc: torch.Tensor,  # (F, K, D)
    src_idx: torch.Tensor,
    dst_idx: torch.Tensor,
    binary: bool,
    mp: MatchParams,
    generator: Optional[torch.Generator] = None,
) -> AlignResult:
    """The per-pair half of :func:`find_alignment_indexed` on the frames'
    keypoints and descriptors."""
    src_idx = src_idx.to(device=desc.device, dtype=torch.int64)
    dst_idx = dst_idx.to(device=desc.device, dtype=torch.int64)
    k0 = Keypoints(*(a[src_idx] for a in kps))
    k1 = Keypoints(*(a[dst_idx] for a in kps))
    return _match_and_fit(
        k0, desc[src_idx], k1, desc[dst_idx], binary, mp, generator
    )


def find_alignment_batched_device(
    srcs: torch.Tensor,  # (N, H, W)
    dsts: torch.Tensor,  # (N, H', W')
    ftype: int,
    orb: OrbParams,
    surf: SurfParams,
    mp: MatchParams,
    generator: Optional[torch.Generator] = None,
) -> AlignResult:
    """:func:`find_alignment_device` over a leading pair axis (everything is
    fixed-capacity, so the pairs are a pure batch dimension)."""
    kps0, desc0, binary = _detect_describe_device(srcs, ftype, orb, surf)
    kps1, desc1, _ = _detect_describe_device(dsts, ftype, orb, surf)
    return _match_and_fit(kps0, desc0, kps1, desc1, binary, mp, generator)


def resolve_feature_params(
    im_args: Mapping, args: Mapping
) -> Tuple[int, OrbParams, SurfParams, MatchParams]:
    """Resolve the (hashable) parameter bundle for the device aligner from
    the job config precedence chain."""
    return (
        feature_type(im_args, args),
        OrbParams.from_config(im_args, args),
        SurfParams.from_config(im_args, args),
        MatchParams.from_config(im_args, args),
    )


def print_align_warnings(
    enough: bool, homo_ok: bool, H: np.ndarray, debug: bool
) -> None:
    """Reproduce the reference's per-pair stderr/stdout diagnostics
    (src/features.cpp:134-147,157-166)."""
    if not enough:
        print("Not enough matches. Using no transformation")
        return
    if not homo_ok:
        print(
            "More than twenty percent variance in zoom or no homography "
            "found, this is probably an error, ignoring the transformation."
        )
    if debug:
        print(H)


def find_alignment(
    src: np.ndarray,
    dst: np.ndarray,
    im_args: Mapping,
    args: Mapping,
    device="cuda",
) -> np.ndarray:
    """Estimate the 2x3 affine mapping src coordinates into dst space.

    Host-facing wrapper: the frames go to ``device``, one readback brings
    the whole result bundle."""
    debug = bool(args.get("debug", False))
    ftype, orb, surf, mp = resolve_feature_params(im_args, args)

    res = find_alignment_device(
        torch.as_tensor(np.ascontiguousarray(src, np.float32), device=device),
        torch.as_tensor(np.ascontiguousarray(dst, np.float32), device=device),
        ftype, orb, surf, mp,
    )
    # single host transfer of the full result bundle
    packed = torch.cat([
        res.affine.reshape(-1), res.H.reshape(-1).to(torch.float32),
        torch.stack([res.n_good, res.enough, res.homo_ok]).to(torch.float32),
    ]).cpu().numpy()
    affine, H = packed[:6].reshape(2, 3), packed[6:15].reshape(3, 3)
    n_good, enough, homo_ok = int(packed[15]), bool(packed[16]), bool(packed[17])

    if debug:
        print(f"Number of good features: {n_good}")
    print_align_warnings(enough, homo_ok, H, debug)
    if not (enough and homo_ok):
        return IDENTITY.copy()
    return np.asarray(affine, dtype=np.float32)
