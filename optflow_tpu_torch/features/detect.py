"""Keypoint detectors in plain PyTorch.

The reference delegates to OpenCV CUDA detectors (src/features.cpp:54-94):
ORB (FAST corners over an image pyramid) for ``features == 1`` and SURF
(determinant-of-Hessian blobs over octaves) for ``features == 2``.
Counterpart of the JAX package's ``features/detect.py``:

- :func:`hessian_keypoints` — SURF-class: Gaussian scale-space
  determinant-of-Hessian with per-octave downsampling, 3x3 spatial +
  scale non-max suppression, fixed-capacity top-K output (a validity mask
  marks real detections).
- :func:`fast_keypoints` — ORB-class: FAST-style segment-test corners on a
  ``nlevels`` pyramid with response ranking and intensity-centroid
  orientation.

Everything returns fixed-capacity tensors (x, y, sigma, angle, response,
valid) so downstream description/matching is fully batched. Both detectors
take one ``(H, W)`` image or a stack ``(F, H, W)`` of frames of one size;
the stack is processed as a batch (a leading axis on every field).

``torch.topk`` promises no order among equal responses where the JAX
package's top_k prefers the lower index: the two packages agree on the SET
of valid keypoints (up to near-ties at the threshold), not on their slots.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from optflow_tpu_torch.ops.pyramid import resize_bilinear


class Keypoints(NamedTuple):
    x: torch.Tensor  # (K,) or (F, K) float32, full-resolution coords
    y: torch.Tensor
    sigma: torch.Tensor  # detection scale
    angle: torch.Tensor  # radians
    response: torch.Tensor
    valid: torch.Tensor  # bool


def _batched(im: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if im.dim() == 2:
        return im[None].to(torch.float32), True
    if im.dim() != 3:
        raise ValueError(f"expected (H, W) or (F, H, W), got {tuple(im.shape)}")
    return im.to(torch.float32), False


def _unbatch(kps: Keypoints, single: bool) -> Keypoints:
    return Keypoints(*(a[0] for a in kps)) if single else kps


# ------------------------------------------------------------ convolution


def _gauss_kernel(sigma: float, order: int = 0) -> np.ndarray:
    """1D Gaussian (or its 1st/2nd derivative) kernel, numpy."""
    r = max(2, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2) / (sigma * math.sqrt(2 * math.pi))
    if order == 0:
        k = g
        k = k / k.sum()
    elif order == 1:
        # conv2d is cross-correlation (no kernel flip), so the odd
        # first-derivative kernel carries +x to yield d/dx.
        k = x / sigma**2 * g
    else:
        k = (x**2 - sigma**2) / sigma**4 * g
    return k.astype(np.float32)


def _conv1d(im: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """Zero-SAME-padded 1D cross-correlation along ``axis`` (0 = rows, 1 =
    columns) of every image of an ``(F, H, W)`` stack, in full float32 (the
    convolution library's TF32 mode would leave the responses three
    digits)."""
    r = (len(k) - 1) // 2
    kernel = torch.as_tensor(k, dtype=torch.float32, device=im.device)
    if axis == 0:
        weight, pad = kernel.reshape(1, 1, -1, 1), (r, 0)
    else:
        weight, pad = kernel.reshape(1, 1, 1, -1), (0, r)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(im[:, None], weight, padding=pad)[:, 0]


def gaussian_blur(im: torch.Tensor, sigma: float) -> torch.Tensor:
    k = _gauss_kernel(sigma, 0)
    return _conv1d(_conv1d(im, k, 0), k, 1)


def gaussian_gradients(
    im: torch.Tensor, sigma: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigma-scale first derivatives (d/dx, d/dy) of an (F, H, W) stack."""
    g = _gauss_kernel(sigma, 0)
    d = _gauss_kernel(sigma, 1)
    ix = _conv1d(_conv1d(im, g, 0), d, 1)
    iy = _conv1d(_conv1d(im, d, 0), g, 1)
    return ix, iy


def _doh_response(im: torch.Tensor, sigma: float) -> torch.Tensor:
    """sigma^4-normalized determinant of Hessian."""
    g = _gauss_kernel(sigma, 0)
    d1 = _gauss_kernel(sigma, 1)
    d2 = _gauss_kernel(sigma, 2)
    lxx = _conv1d(_conv1d(im, g, 0), d2, 1)
    lyy = _conv1d(_conv1d(im, d2, 0), g, 1)
    lxy = _conv1d(_conv1d(im, d1, 0), d1, 1)
    return (sigma**4) * (lxx * lyy - lxy * lxy)


def _max3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 maximum with -inf beyond the border (max_pool2d pads so)."""
    return F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]


def _inside(h: int, w: int, margin: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def _topk_keypoints(
    response: torch.Tensor,  # (F, h, w)
    is_peak: torch.Tensor,
    capacity: int,
    threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-capacity top-K (x, y, response, valid), each (F, capacity),
    from a response map."""
    f, h, w = response.shape
    masked = torch.where(
        is_peak, response, torch.full_like(response, -math.inf)
    )
    vals, idx = torch.topk(masked.reshape(f, -1), min(capacity, h * w), dim=1)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    return xs, ys, vals, vals > threshold


def _final_topk(xs, ys, resp, valid, sig, ang, capacity, threshold) -> Keypoints:
    """Global top-K by response among the per-scale candidates."""
    masked = torch.where(valid, resp, torch.full_like(resp, -math.inf))
    vals, idx = torch.topk(masked, min(capacity, masked.shape[1]), dim=1)
    return Keypoints(
        x=torch.gather(xs, 1, idx),
        y=torch.gather(ys, 1, idx),
        sigma=torch.gather(sig, 1, idx),
        angle=torch.zeros_like(vals) if ang is None else torch.gather(ang, 1, idx),
        response=vals,
        valid=torch.isfinite(vals) & (vals > threshold),
    )


# ------------------------------------------------------------ SURF-class

# Empirical scale factor mapping the Gaussian DoH responses into the same
# magnitude regime as the reference's box-filter DoH, so configured
# hessianThreshold values (400 default, 1600 production) select comparable
# keypoint counts on 0..255 images.
_DOH_RESPONSE_SCALE = 16.0


def hessian_keypoints(
    im: torch.Tensor,
    hessian_threshold: float = 400.0,
    n_octaves: int = 4,
    n_octave_layers: int = 2,
    capacity: int = 1024,
) -> Keypoints:
    """SURF-class determinant-of-Hessian blob detector
    (ref: cv::cuda::SURF_CUDA configured at src/features.cpp:79-87)."""
    ims, single = _batched(im)
    threshold = float(hessian_threshold)
    n_octaves, n_octave_layers = int(n_octaves), int(n_octave_layers)
    capacity = int(capacity)
    per_scale = []  # (xs, ys, resp, valid, sigma)
    cap_per = max(capacity // max(n_octaves * n_octave_layers, 1), 16)

    with torch.no_grad():
        octave_im = ims
        for o in range(n_octaves):
            oh, ow = octave_im.shape[-2:]
            if oh < 16 or ow < 16:
                break
            # Layer sigmas within the octave (relative to the octave image).
            base = 1.2
            sigmas = [base * (1.3**l) for l in range(n_octave_layers + 2)]
            stack = [_doh_response(octave_im, s) for s in sigmas]
            for l in range(1, n_octave_layers + 1):
                r = stack[l]
                spatial_peak = r >= _max3x3(r)
                scale_peak = (r >= stack[l - 1]) & (r >= stack[l + 1])
                # keep away from borders (descriptor support)
                margin = int(math.ceil(3 * sigmas[l])) + 1
                inside = _inside(oh, ow, margin, r.device)
                xs, ys, vals, valid = _topk_keypoints(
                    r * _DOH_RESPONSE_SCALE,
                    spatial_peak & scale_peak & inside,
                    cap_per,
                    threshold,
                )
                zoom = float(2**o)
                per_scale.append((
                    xs * zoom, ys * zoom, vals, valid,
                    torch.full_like(xs, sigmas[l] * zoom),
                ))
            octave_im = resize_bilinear(
                octave_im, (max(oh // 2, 8), max(ow // 2, 8))
            )
        xs, ys, resp, valid, sig = (
            torch.cat([p[i] for p in per_scale], dim=1) for i in range(5)
        )
        kps = _final_topk(xs, ys, resp, valid, sig, None, capacity, threshold)
    return _unbatch(kps, single)


# ------------------------------------------------------------ FAST / ORB

# Bresenham circle of radius 3 (the FAST-16 ring).
_FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
        (-1, -3),
    ],
    dtype=np.int32,
)


def _shift2d(im: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with edge replication (value at (y, x) becomes im[y+dy, x+dx])."""
    h, w = im.shape[-2:]
    ys = (torch.arange(h, device=im.device) + dy).clamp(0, h - 1)
    xs = (torch.arange(w, device=im.device) + dx).clamp(0, w - 1)
    return im[:, ys][:, :, xs]


def _fast_response(im: torch.Tensor, fast_threshold: float) -> torch.Tensor:
    """FAST-9/16 segment test + SAD response on an (F, H, W) stack."""
    ring = torch.stack(
        [_shift2d(im, int(dy), int(dx)) for dx, dy in _FAST_RING]
    )  # (16, F, H, W)
    diff = ring - im[None]
    brighter = diff > fast_threshold
    darker = diff < -fast_threshold

    def contiguous9(flags):
        # any run of 9 consecutive (cyclic) positives
        acc = torch.zeros_like(flags[0])
        doubled = torch.cat([flags, flags[:8]], dim=0)
        for s in range(16):
            acc = acc | doubled[s:s + 9].all(dim=0)
        return acc

    is_corner = contiguous9(brighter) | contiguous9(darker)
    response = (diff.abs() * (brighter | darker).to(im.dtype)).sum(dim=0)
    return torch.where(is_corner, response, torch.zeros_like(response))


def _intensity_centroid_angle(
    im: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, radius: int = 15
) -> torch.Tensor:
    """ORB's intensity-centroid orientation: angle of the patch centroid
    relative to the corner position, on an (F, H, W) stack with (F, K)
    corners. The detector centers are integral, so the patch is the image's
    own pixels."""
    from optflow_tpu_torch.features.patches import extract_patches

    p = 2 * radius + 1
    offs = np.arange(-radius, radius + 1, dtype=np.float32)
    oy, ox = np.meshgrid(offs, offs, indexing="ij")
    circle = (ox**2 + oy**2) <= radius**2
    wx = torch.as_tensor((ox * circle).astype(np.float32), device=im.device)
    wy = torch.as_tensor((oy * circle).astype(np.float32), device=im.device)

    pats = extract_patches(
        im[:, None], torch.floor(xs), torch.floor(ys), torch.ones_like(xs),
        p, 1.0,
    )[:, 0]  # (F, K, P, P)
    m10 = (pats * wx).sum(dim=(-2, -1))
    m01 = (pats * wy).sum(dim=(-2, -1))
    return torch.atan2(m01, m10)


def fast_keypoints(
    im: torch.Tensor,
    fast_threshold: float = 20.0,
    scale_factor: float = 1.2,
    nlevels: int = 8,
    capacity: int = 1024,
    edge_threshold: int = 31,
) -> Keypoints:
    """ORB-class FAST corner detector over a pyramid
    (ref: cv::cuda::ORB configured at src/features.cpp:58)."""
    ims, single = _batched(im)
    fast_threshold, scale_factor = float(fast_threshold), float(scale_factor)
    nlevels, capacity = int(nlevels), int(capacity)
    edge_threshold = int(edge_threshold)
    cap_per = max(capacity // nlevels, 32)
    per_level = []
    with torch.no_grad():
        level_im = ims
        for lvl in range(nlevels):
            lh, lw = level_im.shape[-2:]
            if lh < 2 * edge_threshold + 8 or lw < 2 * edge_threshold + 8:
                break
            resp = _fast_response(level_im, fast_threshold)
            peak = resp >= _max3x3(resp)
            inside = _inside(lh, lw, edge_threshold, resp.device)
            xs, ys, vals, valid = _topk_keypoints(
                resp, peak & inside & (resp > 0), cap_per, 0.0
            )
            angle = _intensity_centroid_angle(level_im, xs, ys)
            zoom = float(scale_factor**lvl)
            per_level.append((
                xs * zoom, ys * zoom, vals, valid,
                torch.full_like(xs, zoom), angle,
            ))
            nh = int(round(lh / scale_factor))
            nw = int(round(lw / scale_factor))
            level_im = resize_bilinear(level_im, (nh, nw))
        xs, ys, resp, valid, sig, ang = (
            torch.cat([p[i] for p in per_level], dim=1) for i in range(6)
        )
        kps = _final_topk(xs, ys, resp, valid, sig, ang, capacity, 0.0)
    return _unbatch(kps, single)
