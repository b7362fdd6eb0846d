"""Per-pair solve pipeline: ROI loop, feature pre-alignment, TV-L1 solve,
map/flow composition, background masking, output emission.

Implements solve_rois / solve_wrapper (src/optflow.cpp:312-496) with the
composition quirks preserved:

- features branch: absolute map = flow + identity, then the ROI-local map
  images are resampled by the full-frame affine with cv::warpAffine
  semantics (src/optflow.cpp:429-432) — the reference's approximation, kept
  for output parity; output "flow" subtracts identity back, any other
  output keeps the absolute map (src/optflow.cpp:434-443)
- non-features "map" output adds the identity map (src/optflow.cpp:445-466)
- background zero-mask where (possibly warped) frame1 <= 1.0 intensity
  (src/optflow.cpp:467-473)
- random_points valid mask = union of frame0 > 1 and frame1 > 1
  (src/optflow.cpp:486-493)
- custom_diff ROIs: different rects per frame, features ignored with a
  warning (src/optflow.cpp:351-363)
- the ``default`` ROI or a frame-size mismatch force feature pre-alignment
  even when not requested (src/optflow.cpp:366-377)

Deviations from the reference, shared with the JAX package:
- alignment is computed once per pair and the warped frame reused across
  ROIs; the reference re-runs find_alignment on the already-warped frame
  for every subsequent ROI, compounding interpolation blur
- the identity map is built on the device, not by a host double loop
  (src/optflow.cpp:417-426)
- custom_diff always sees the unwarped frame1 even if an earlier ROI
  triggered feature warping

As in the JAX package, ``aligner=None`` means NO alignment on this
sequential path: a pair that takes the feature branch is warped by the
identity and composed with it. The CLI passes
``engine.features_glue.default_aligner`` bound to its ``--device``.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from optflow_tpu_torch.core.config import TVL1Params, cfg_get, resolve_features
from optflow_tpu_torch.core.imgio import write_float_tiff
from optflow_tpu_torch.engine.rois import Roi
from optflow_tpu_torch.engine.sampler import random_points
from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched
from optflow_tpu_torch.ops.warp import affine_warp

IDENTITY_AFFINE = np.array([[1.0, 0, 0], [0, 1.0, 0]], dtype=np.float32)

# aligner(frame1, frame0, im_args, args) -> 2x3 affine mapping frame1
# coords into frame0 space (the find_alignment contract,
# src/features.cpp:46-167 called at src/optflow.cpp:373).
Aligner = Callable[[np.ndarray, np.ndarray, Mapping, Mapping], np.ndarray]


def _solve_mode(features: bool, output_type: str) -> str:
    if features:
        return "features_flow" if output_type == "flow" else "features_map"
    return "map" if output_type == "map" else "displacement"


def postprocess_flow(
    flow: torch.Tensor,  # (N, h, w, 2)
    i0s: torch.Tensor,  # (N, h, w)
    i1s: torch.Tensor,
    mode: str,
    affines: Optional[torch.Tensor] = None,  # (N, 2, 3), features modes
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's solve_wrapper composition (src/optflow.cpp:411-493)
    for a batch: identity-map composition for ``mode == "map"``; for the
    ``features_*`` modes the absolute map resampled by each pair's affine
    with the exact :func:`affine_warp` (and the identity subtracted again
    for ``features_flow``); flow zeroed where frame1 is background
    (<= 1.0), and the union valid mask. Returns (out_x, out_y, valid)."""
    fx = flow[..., 0]
    fy = flow[..., 1]
    if mode != "displacement":
        h, w = fx.shape[-2:]
        mx = torch.arange(w, dtype=torch.float32, device=fx.device)
        my = torch.arange(h, dtype=torch.float32, device=fx.device)[:, None]
    if mode.startswith("features"):
        if affines is None:
            raise ValueError(f"mode {mode!r} needs the pairs' affines")
        nx = affine_warp(fx + mx, affines)
        ny = affine_warp(fy + my, affines)
        if mode == "features_flow":
            fx, fy = nx - mx, ny - my
        else:
            fx, fy = nx, ny
    elif mode == "map":
        fx = fx + mx
        fy = fy + my
    bg = i1s <= 1.0
    fx = torch.where(bg, torch.zeros_like(fx), fx)
    fy = torch.where(bg, torch.zeros_like(fy), fy)
    valid = (i0s > 1.0) | (i1s > 1.0)
    return fx, fy, valid


def _affine_warp_frame(
    frame: np.ndarray, affine: np.ndarray, out_shape, device
) -> np.ndarray:
    """cv::cuda::warpAffine of a whole frame into ``out_shape`` (frame0's,
    which may differ from the frame's own) on ``device``."""
    warped = affine_warp(
        torch.as_tensor(np.ascontiguousarray(frame, np.float32), device=device),
        torch.as_tensor(np.asarray(affine, np.float32), device=device),
        out_shape=tuple(out_shape),
    )
    return warped.cpu().numpy()


def solve_wrapper(
    f0_roi: np.ndarray,
    f1_roi: np.ndarray,
    im_args: Dict,
    args: Mapping,
    features: bool,
    roi_vec: Tuple[Roi, Roi],
    *,
    affine: Optional[np.ndarray] = None,
    write_outputs: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Solve one ROI pair and emit its outputs (ref: src/optflow.cpp:395-496).
    ``affine`` is the pair's 2x3 pre-alignment (identity when absent); it is
    read with ``features`` only.

    Returns {"flow_x", "flow_y", "valid"} as numpy arrays.
    """
    params = TVL1Params.from_config(im_args, args)
    output_type = str(cfg_get(im_args, args, "output_type", "map"))
    mode = _solve_mode(features, output_type)
    i0 = torch.as_tensor(
        np.ascontiguousarray(f0_roi, np.float32), device=device
    )[None]
    i1 = torch.as_tensor(
        np.ascontiguousarray(f1_roi, np.float32), device=device
    )[None]
    flow = tvl1_flow_batched(i0, i1, params)
    aff = torch.as_tensor(
        np.asarray(IDENTITY_AFFINE if affine is None else affine, np.float32),
        device=device,
    )[None]
    fx, fy, valid = postprocess_flow(flow, i0, i1, mode, aff)
    fx = fx[0].cpu().numpy()
    fy = fy[0].cpu().numpy()
    valid = valid[0].cpu().numpy()

    if output_type in ("map", "flow") and write_outputs:
        base = str(im_args.get("output", "")) + str(
            im_args.get("output_suffix", "")
        )
        write_float_tiff(base + "_x.tiff", fx)
        write_float_tiff(base + "_y.tiff", fy)

    if output_type == "random_points":
        scale = float(cfg_get(im_args, args, "scale", 0.5))
        im_args["point_matches"] = random_points(
            fx,
            fy,
            valid,
            roi_vec,
            npoints=int(cfg_get(im_args, args, "npoints", 25)),
            inv_scale=1.0 / scale,
            features=features,
            debug=bool(args.get("debug", False)),
            point_matches=im_args.get("point_matches"),
        )
    return {"flow_x": fx, "flow_y": fy, "valid": valid}


def solve_rois(
    frame0: np.ndarray,
    frame1: np.ndarray,
    rois: Mapping[str, object],
    im_args: Dict,
    args: Mapping,
    aligner: Optional[Aligner] = None,
    *,
    write_outputs: bool = True,
    device="cuda",
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-pair ROI loop (ref: src/optflow.cpp:312-392).

    Iterates ROI keys in sorted order (jsoncpp getMemberNames order) so the
    features-persistence behavior matches the reference. Returns per-key
    result dicts. Without an ``aligner`` a pair that takes the feature
    branch is aligned by the identity, as in the JAX package.
    """
    features = resolve_features(im_args, args)
    affine = IDENTITY_AFFINE
    warped_frame1: Optional[np.ndarray] = None
    results: Dict[str, Dict[str, np.ndarray]] = {}
    size_mismatch = frame0.shape != frame1.shape

    for roi_key in sorted(rois.keys()):
        if roi_key in ("top", "bottom"):
            im_args["output_suffix"] = "_" + roi_key
        else:
            im_args["output_suffix"] = ""

        if roi_key == "custom_diff":
            if features:
                print(
                    "Features isn't compatible with different ROIs for each "
                    "image.\n Ignoring features.",
                    file=sys.stderr,
                )
            roi_0, roi_1 = rois[roi_key]  # type: ignore[misc]
            if roi_0.shape != roi_1.shape:
                # The reference would crash inside the GPU solver; we crop
                # both rects to the common size instead.
                ch = min(roi_0.height, roi_1.height)
                cw = min(roi_0.width, roi_1.width)
                roi_0 = Roi(roi_0.x, roi_0.y, cw, ch)
                roi_1 = Roi(roi_1.x, roi_1.y, cw, ch)
            results[roi_key] = solve_wrapper(
                frame0[roi_0.slices()],
                frame1[roi_1.slices()],
                im_args,
                args,
                False,
                (roi_0, roi_1),
                write_outputs=write_outputs,
                device=device,
            )
            continue

        if features or size_mismatch or roi_key == "default":
            if (size_mismatch or roi_key == "default") and not features:
                print(
                    "Rows or columns differ between frames no ROI selected, "
                    "reverting to features even though it wasn't selected.",
                    file=sys.stderr,
                )
            if warped_frame1 is None:
                if aligner is not None:
                    affine = np.asarray(
                        aligner(frame1, frame0, im_args, args),
                        dtype=np.float32,
                    )
                warped_frame1 = _affine_warp_frame(
                    frame1, affine, frame0.shape, device
                )
            features = True
            f1_full = warped_frame1
        else:
            f1_full = frame1

        roi: Roi = rois[roi_key]  # type: ignore[assignment]
        results[roi_key] = solve_wrapper(
            frame0[roi.slices()],
            f1_full[roi.slices()],
            im_args,
            args,
            features,
            (roi, roi),
            affine=affine,
            write_outputs=write_outputs,
            device=device,
        )

    return results
