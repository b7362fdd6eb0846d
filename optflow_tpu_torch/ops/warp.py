"""Stencil and warping primitives for the TV-L1 solver, in plain PyTorch.

The device-side equivalents of the OpenCV CUDA kernels the reference leans
on (invoked via cv::cuda::OpticalFlowDual_TVL1 at src/optflow.cpp:516-520):

- centered image gradients (replicate border)
- forward-difference flow gradients / backward-difference divergence
  (the adjoint pair used by the primal-dual scheme)
- backward warping of (I1, I1x, I1y) by the current flow with the
  truncated-cubic-hat interpolation the CUDA kernel uses (2x2 support,
  normalized weights, clamp-to-edge)

- the affine warp of feature pre-alignment (cv::cuda::warpAffine)
- a clamp-to-edge sampler at arbitrary coordinates (the style-2 remap)

Every function works on the trailing ``(H, W)`` axes, so a single image and
an ``(N, H, W)`` batch take the same code. The warps are exact gathers: no
bound on the flow's magnitude or on the affine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def centered_gradient(im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered differences with replicate border.

    dx(y, x) = 0.5 * (im[y, min(x+1, W-1)] - im[y, max(x-1, 0)]).
    """
    right = torch.cat([im[..., :, 1:], im[..., :, -1:]], dim=-1)
    left = torch.cat([im[..., :, :1], im[..., :, :-1]], dim=-1)
    down = torch.cat([im[..., 1:, :], im[..., -1:, :]], dim=-2)
    up = torch.cat([im[..., :1, :], im[..., :-1, :]], dim=-2)
    return 0.5 * (right - left), 0.5 * (down - up)


def forward_gradient(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences, zero at the far border.

    ux(y, x) = u[y, min(x+1, W-1)] - u[y, x]  (so ux = 0 in the last column).
    """
    ux = torch.cat(
        [u[..., :, 1:] - u[..., :, :-1], torch.zeros_like(u[..., :, :1])],
        dim=-1,
    )
    uy = torch.cat(
        [u[..., 1:, :] - u[..., :-1, :], torch.zeros_like(u[..., :1, :])],
        dim=-2,
    )
    return ux, uy


def divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the negative adjoint of
    :func:`forward_gradient`:

    div(y, x) = p1[y, x] - p1[y, x-1] + p2[y, x] - p2[y-1, x]
    with p treated as zero outside the domain on the low side.
    """
    d1 = torch.cat(
        [p1[..., :, :1], p1[..., :, 1:] - p1[..., :, :-1]], dim=-1
    )
    d2 = torch.cat(
        [p2[..., :1, :], p2[..., 1:, :] - p2[..., :-1, :]], dim=-2
    )
    return d1 + d2


def _cubic_hat(t: torch.Tensor) -> torch.Tensor:
    """Central lobe of the Catmull-Rom cubic, evaluated on |t| <= 1.

    The CUDA warp kernel weights its 2x2 window with this function and
    renormalizes, rather than using the plain linear hat.
    """
    a = torch.abs(t)
    return a * a * (1.5 * a - 2.5) + 1.0


def bilinear_sample(
    im: torch.Tensor,  # (H, W)
    x: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """Bilinear sample of ``im`` at float coordinates ``(x, y)`` (any shape,
    the same for both) with clamp-to-edge borders."""
    h, w = im.shape
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    flat = im.reshape(-1)

    def tap(yi, xi):  # the flat index clipped, as jnp.take(mode="clip")
        return flat[torch.clamp(yi * w + xi, 0, h * w - 1)]

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x1i)
    v10 = tap(y1i, x0i)
    v11 = tap(y1i, x1i)
    return (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * (
        (1 - fx) * v10 + fx * v11
    )


def warp_backward(
    i0: torch.Tensor,
    i1: torch.Tensor,
    i1x: torch.Tensor,
    i1y: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp (i1, i1x, i1y) backward by the flow and linearize the residual.

    Returns (i1w, i1wx, i1wy, grad, rho_c) where
      grad  = i1wx^2 + i1wy^2
      rho_c = i1w - i1wx*u1 - i1wy*u2 - i0
    matching the reference GPU pipeline's warp step run once per warp
    iteration (nscales x warps times per pair).
    """
    h, w = i0.shape[-2:]
    lead = i0.shape[:-2]
    xs = torch.arange(w, dtype=torch.float32, device=i0.device)
    ys = torch.arange(h, dtype=torch.float32, device=i0.device)[:, None]

    # Indices are clamped so the 2x2 window starting at (y0, x0) is always
    # in bounds: when x lands exactly on the last column, x0 shifts left by
    # one and fx becomes 1, which weights the same pixel — identical result.
    x = torch.clamp(xs + u1, 0.0, w - 1.0)
    y = torch.clamp(ys + u2, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x), max=w - 2.0)
    y0 = torch.clamp(torch.floor(y), max=h - 2.0)
    fx = x - x0
    fy = y - y0
    wx0 = _cubic_hat(fx)
    wx1 = _cubic_hat(1.0 - fx)
    wy0 = _cubic_hat(fy)
    wy1 = _cubic_hat(1.0 - fy)
    inv_norm = 1.0 / ((wx0 + wx1) * (wy0 + wy1))

    base = (y0.to(torch.int64) * w + x0.to(torch.int64)).reshape(*lead, h * w)

    def sample(im: torch.Tensor) -> torch.Tensor:
        flat = im.reshape(*lead, h * w)
        v00 = torch.gather(flat, -1, base).reshape(i0.shape)
        v01 = torch.gather(flat, -1, base + 1).reshape(i0.shape)
        v10 = torch.gather(flat, -1, base + w).reshape(i0.shape)
        v11 = torch.gather(flat, -1, base + w + 1).reshape(i0.shape)
        return inv_norm * (
            wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11)
        )

    i1w = sample(i1)
    i1wx = sample(i1x)
    i1wy = sample(i1y)
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
    return i1w, i1wx, i1wy, grad, rho_c


def invert_affine(affine: torch.Tensor) -> torch.Tensor:
    """Invert ``(..., 2, 3)`` affine matrices (cv::invertAffineTransform); a
    singular matrix inverts to zeros."""
    a, b, tx = affine[..., 0, 0], affine[..., 0, 1], affine[..., 0, 2]
    c, d, ty = affine[..., 1, 0], affine[..., 1, 1], affine[..., 1, 2]
    det = a * d - b * c
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    ia = d * inv_det
    ib = -b * inv_det
    ic = -c * inv_det
    id_ = a * inv_det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack(
        [torch.stack([ia, ib, itx], dim=-1), torch.stack([ic, id_, ity], dim=-1)],
        dim=-2,
    )


def affine_warp(
    im: torch.Tensor,  # (H, W) or (N, H, W)
    affine: torch.Tensor,  # (2, 3) or (N, 2, 3)
    out_shape: Optional[Tuple[int, int]] = None,
    fill: float = 0.0,
) -> torch.Tensor:
    """cv::cuda::warpAffine semantics (src/optflow.cpp:374,431-432):

    ``affine`` is the *forward* 2x3 matrix; the output pixel at (x, y)
    samples the input at affine^-1 (x, y) with bilinear interpolation and a
    constant border (taps outside the source contribute ``fill``). A batch
    takes one matrix per image.
    """
    single = im.dim() == 2
    ims = im[None] if single else im
    affs = affine.reshape(-1, 2, 3).to(torch.float32)
    n, h, w = ims.shape
    if affs.shape[0] != n:
        raise ValueError(f"{n} images but {affs.shape[0]} affine matrices")
    oh, ow = (h, w) if out_shape is None else out_shape
    inv = invert_affine(affs)[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    xs = torch.arange(ow, dtype=torch.float32, device=ims.device)
    ys = torch.arange(oh, dtype=torch.float32, device=ims.device)[:, None]
    sx = inv[:, 0, 0] * xs + inv[:, 0, 1] * ys + inv[:, 0, 2]  # (N, oh, ow)
    sy = inv[:, 1, 0] * xs + inv[:, 1, 1] * ys + inv[:, 1, 2]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    # far-off samples (a degenerate matrix) stay representable as indices
    x0i = x0.clamp(-2.0, w + 1.0).to(torch.int64)
    y0i = y0.clamp(-2.0, h + 1.0).to(torch.int64)
    flat = ims.to(torch.float32).reshape(n, h * w)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        val = torch.gather(flat, 1, idx.reshape(n, -1)).reshape(n, oh, ow)
        return torch.where(valid, val, torch.full_like(val, fill))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    out = (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * (
        (1 - fx) * v10 + fx * v11
    )
    return out[0] if single else out
