"""Keypoint patch extraction and in-patch sampling.

The descriptor stages need image values at thousands of per-keypoint
sub-pixel locations (SURF's rotated 20x20 sigma-grid, ORB's rotated BRIEF
test pairs, the FAST intensity-centroid disk — the work
cv::cuda::SURF_CUDA / cv::cuda::ORB do on GPU, src/features.cpp:58-92).

Counterpart of the JAX package's ``features/patches.py``. What is ported is
the FUNCTION, not its formulation: the JAX module turns the sampling into
bfloat16 matrix products against hat-weight matrices because gathers are
slow on its hardware; the function those products approximate is a bilinear
interpolation with clamp-to-edge, and on a GPU that is a plain gather. Here
it is computed exactly in float32, so this module agrees with the JAX one
only to the precision of the latter's bfloat16 weights (about three
digits).

1. **Patch extraction** — for each keypoint k, a sigma-normalized (P x P)
   patch ``patch[k, p, q] = I(y_k + s_k*step*(p-c), x_k + s_k*step*(q-c))``.
2. **In-patch sampling** — arbitrary rotated/scaled sample positions
   (px, py) inside the patch, again bilinear.

Border semantics: clamp-to-edge (positions are clipped to the image or the
patch before interpolation, so an out-of-range tap lands with full weight on
the border row/column).

Every function takes an optional leading frame axis: images ``(C, H, W)``
with keypoints ``(K,)``, or ``(F, C, H, W)`` with ``(F, K)``.
"""

from __future__ import annotations

import torch


def _bilinear_gather(
    ims: torch.Tensor,  # (B, C, H, W) float32
    px: torch.Tensor,  # (B, M) x positions
    py: torch.Tensor,  # (B, M)
) -> torch.Tensor:
    """(B, C, M) bilinear samples of every channel at its batch entry's M
    positions, clamp-to-edge."""
    b, c, h, w = ims.shape
    px = px.clamp(0.0, float(w - 1))
    py = py.clamp(0.0, float(h - 1))
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0)[:, None, :]
    fy = (py - y0)[:, None, :]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    flat = ims.reshape(b, c, h * w)

    def tap(yi, xi):
        idx = (yi * w + xi)[:, None, :].expand(b, c, -1)
        return torch.gather(flat, 2, idx)

    top = (1.0 - fx) * tap(y0, x0) + fx * tap(y0, x1)
    bot = (1.0 - fx) * tap(y1, x0) + fx * tap(y1, x1)
    return (1.0 - fy) * top + fy * bot


def extract_patches(
    ims: torch.Tensor,  # (C, H, W) or (F, C, H, W) — shared sampling fields
    x: torch.Tensor,  # (K,) or (F, K) keypoint centers
    y: torch.Tensor,
    sigma: torch.Tensor,  # per-keypoint scale
    patch: int,  # P — patch side
    step: float,  # grid spacing in sigma units
) -> torch.Tensor:
    """(C, K, P, P) — or (F, C, K, P, P) — sigma-normalized patches,
    bilinearly resampled from ``ims``."""
    single = ims.dim() == 3
    if single:
        ims, x, y, sigma = ims[None], x[None], y[None], sigma[None]
    f, c = ims.shape[:2]
    k = x.shape[1]
    p = patch
    centers = (
        torch.arange(p, dtype=torch.float32, device=ims.device) - (p - 1) / 2.0
    ) * step
    x, y, sigma = (t.to(torch.float32) for t in (x, y, sigma))
    pos_x = x[..., None] + sigma[..., None] * centers  # (F, K, P) columns
    pos_y = y[..., None] + sigma[..., None] * centers  # (F, K, P) rows
    gx = pos_x[:, :, None, :].expand(f, k, p, p).reshape(f, k * p * p)
    gy = pos_y[:, :, :, None].expand(f, k, p, p).reshape(f, k * p * p)
    out = _bilinear_gather(ims.to(torch.float32), gx, gy)
    out = out.reshape(f, c, k, p, p)
    return out[0] if single else out


def sample_patches(
    patches: torch.Tensor,  # (..., K, P, P) float32
    px: torch.Tensor,  # (..., K, S) in-patch x coords
    py: torch.Tensor,
) -> torch.Tensor:
    """(..., K, S) bilinear samples of each keypoint's patch at its own
    sample positions, clamp-to-edge at the patch rim."""
    lead = patches.shape[:-2]
    p = patches.shape[-1]
    s = px.shape[-1]
    out = _bilinear_gather(
        patches.reshape(-1, 1, p, p).to(torch.float32),
        px.reshape(-1, s).to(torch.float32),
        py.reshape(-1, s).to(torch.float32),
    )
    return out.reshape(*lead, s)
