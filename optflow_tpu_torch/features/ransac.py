"""Homography estimation with fixed-budget vectorized RANSAC.

Replaces cv::findHomography (src/features.cpp:133) — a CPU hot loop in the
reference — with a batch formulation: a fixed batch of 4-point hypotheses
solved as batched 8x8 linear systems, scored in parallel against all
correspondences, winner selected by masked argmax (RANSAC, method 4) or
minimal median residual (least-median, method 8), then refit by weighted
normalized DLT over the winning inliers. Method 0 uses all points in one
least-squares DLT, matching the reference's "homo" method codes
(docs/example.json:26-31).

Counterpart of the JAX package's ``features/ransac.py``. Every function
takes one pair (``(K, 2)`` points) or a batch of pairs (``(N, K, 2)``). The
hypotheses' point indices come from a ``torch.Generator`` (seeded per call
unless one is passed), which no other framework's generator reproduces; a
caller that needs the same hypotheses as another implementation passes them
as ``samples``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class HomographyResult(NamedTuple):
    H: torch.Tensor  # (3, 3) with H[2, 2] == 1
    inliers: torch.Tensor  # (K,) bool
    n_inliers: torch.Tensor  # () int64
    ok: torch.Tensor  # () bool


def _gj_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dense solve by Gauss-Jordan elimination with partial
    pivoting: A (..., N, N), b (..., N) -> (..., N).

    Degenerate 4-point samples are normal in RANSAC, and a library solve
    raises on a singular matrix. Here singular systems yield large or
    non-finite garbage without an exception (the callers reject by
    residual), and N static steps of vectorized row operations suit a batch
    of 512 8x8 systems per pair.
    """
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)  # (..., N, N+1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        col = M[..., :, k].abs()
        col = torch.where(rows >= k, col, torch.full_like(col, -1.0))
        piv = col.argmax(dim=-1)  # (...,) the first among equal maxima
        prow = torch.gather(
            M, -2, piv[..., None, None].expand(*piv.shape, 1, n + 1)
        )  # (..., 1, N+1)
        # swap row k and the pivot row
        is_k = (rows == k)[:, None]  # (N, 1)
        is_piv = (rows == piv[..., None])[..., None]  # (..., N, 1)
        krow = M[..., k:k + 1, :]
        M = torch.where(is_k, prow, M)
        M = torch.where(is_piv & ~is_k, krow, M)
        # eliminate column k from every other row
        pdiag = M[..., k:k + 1, k:k + 1]
        pdiag = torch.where(
            pdiag.abs() > 1e-12, pdiag, torch.full_like(pdiag, 1e-12)
        )
        factor = M[..., :, k:k + 1] / pdiag  # (..., N, 1)
        upd = M - factor * M[..., k:k + 1, :]
        M = torch.where(is_k, M / pdiag, upd)
    return M[..., :, n]


def _normalization(p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hartley normalization transform (..., 3, 3) for the masked points of
    p (..., K, 2) with mask (..., K) float."""
    wsum = mask.sum(dim=-1).clamp(min=1.0)
    mean = (p * mask[..., None]).sum(dim=-2) / wsum[..., None]  # (..., 2)
    d = torch.sqrt(((p - mean[..., None, :]) ** 2).sum(dim=-1) + 1e-12)
    mean_d = (d * mask).sum(dim=-1) / wsum
    s = math.sqrt(2.0) / mean_d.clamp(min=1e-6)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, z, -s * mean[..., 0]], dim=-1),
        torch.stack([z, s, -s * mean[..., 1]], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def _apply_h(H: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Project (..., K, 2) points through (..., 3, 3) homographies."""
    x, y = p[..., 0], p[..., 1]
    h = H[..., None, :, :]  # broadcast over the K points
    w = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    w = torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    qx = (h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]) / w
    qy = (h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]) / w
    return torch.stack([qx, qy], dim=-1)


def _h_from_vector(h: torch.Tensor) -> torch.Tensor:
    """(..., 8) solution with h22 = 1 -> (..., 3, 3)."""
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(
        *h.shape[:-1], 3, 3
    )


def _dlt_rows(p: torch.Tensor, q: torch.Tensor):
    """The two rows each correspondence adds to the h22 = 1 system:
    (..., K, 8) for u, (..., K, 8) for v."""
    x, y = p[..., 0], p[..., 1]
    u, v = q[..., 0], q[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    return r1, r2


def _solve_h4(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact homographies from 4 correspondences, (..., 4, 2) each, via the
    8x8 system with h22 = 1. Degenerate configurations produce huge or
    non-finite entries, which scoring rejects."""
    r1, r2 = _dlt_rows(p, q)
    # rows ordered point by point: (x-row, y-row) of point 0, of point 1, ...
    A = torch.stack([r1, r2], dim=-2).reshape(*p.shape[:-2], 8, 8)
    b = q.reshape(*q.shape[:-2], 8)
    # Regularize minutely so exactly-singular systems return large-but-
    # finite garbage instead of NaN (still rejected by residuals).
    eye = torch.eye(8, dtype=A.dtype, device=A.device)
    return _h_from_vector(_gj_solve(A + 1e-8 * eye, b))


def _dlt(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted normalized least-squares homography fit (final refit /
    method 0), with h22 pinned to 1 in the Hartley-normalized frame: an 8x8
    normal-equations solve. Normalization centers both clouds, so for the
    near-identity transforms this pipeline accepts (the 20% zoom gate,
    src/features.cpp:134-147) the h22 ~ 0 degeneracy is unreachable.
    p, q: (..., K, 2); w: (..., K) float weights."""
    Tp = _normalization(p, w)
    Tq = _normalization(q, w)
    pn = _apply_h(Tp, p)
    qn = _apply_h(Tq, q)

    r1, r2 = _dlt_rows(pn, qn)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2K, 8)
    b = torch.cat([qn[..., 0], qn[..., 1]], dim=-1)  # (..., 2K)
    ww = torch.cat([w, w], dim=-1)
    Atw = A.transpose(-1, -2) * ww[..., None, :]  # (..., 8, 2K)
    eye = torch.eye(8, dtype=A.dtype, device=A.device)
    AtA = torch.matmul(Atw, A) + 1e-8 * eye
    Atb = torch.matmul(Atw, b[..., None])[..., 0]
    Hn = _h_from_vector(_gj_solve(AtA, Atb))
    # Denormalize: H = Tq^{-1} Hn Tp, solving Tq X = Hn column-by-column.
    Tq3 = Tq[..., None, :, :].expand(*Tq.shape[:-2], 3, 3, 3)
    X = _gj_solve(Tq3, Hn.transpose(-1, -2)).transpose(-1, -2)
    H = torch.matmul(X, Tp)
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() > 1e-12, h22, torch.full_like(h22, 1e-12))


def _median_of_valid(residuals: torch.Tensor, mask: torch.Tensor):
    """Median of each hypothesis' residuals over the masked points,
    averaging the two middle values of an even count (numpy's nanmedian
    convention; ``torch.nanmedian`` would take the lower one). residuals
    (..., B, K), mask (..., K) bool -> (..., B); +inf with no valid point."""
    inf = torch.full_like(residuals, math.inf)
    ordered, _ = torch.sort(
        torch.where(mask[..., None, :], residuals, inf), dim=-1
    )
    n = mask.sum(dim=-1)[..., None, None]  # (..., 1, 1)
    lo = torch.gather(ordered, -1, ((n - 1).clamp(min=0) // 2).expand(
        *ordered.shape[:-1], 1))
    hi = torch.gather(ordered, -1, (n // 2).clamp(max=ordered.shape[-1] - 1)
                      .expand(*ordered.shape[:-1], 1))
    # equal infinities must not turn into inf - inf
    med = torch.where(lo == hi, lo, 0.5 * (lo + hi))[..., 0]
    return torch.where(n[..., 0] > 0, med, torch.full_like(med, math.inf))


def draw_samples(
    mask: torch.Tensor,  # (..., K) bool
    n_hypotheses: int,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
) -> torch.Tensor:
    """(..., n_hypotheses, 4) int64 point indices drawn with replacement
    from the masked correspondences, uniformly (index 0 where a pair has
    none). Without a ``generator`` one is seeded with ``seed`` on the mask's
    device, so a call is reproducible on that device."""
    if generator is None:
        generator = torch.Generator(device=mask.device)
        generator.manual_seed(int(seed))
    flat = mask.reshape(-1, mask.shape[-1]).to(torch.float32)
    empty = flat.sum(dim=-1, keepdim=True) == 0
    probs = torch.where(empty, torch.ones_like(flat), flat)
    idx = torch.multinomial(
        probs, n_hypotheses * 4, replacement=True, generator=generator
    )
    idx = torch.where(empty, torch.zeros_like(idx), idx)
    return idx.reshape(*mask.shape[:-1], n_hypotheses, 4)


def find_homography(
    p0: torch.Tensor,
    p1: torch.Tensor,
    mask: torch.Tensor,
    thresh: float = 5.0,
    method: int = 4,
    n_hypotheses: int = 512,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> HomographyResult:
    """Estimate the homography mapping p0 -> p1 over masked correspondences.

    Args:
      p0, p1: (K, 2) float32 matched point coordinates, or (N, K, 2).
      mask: (K,) or (N, K) bool valid-correspondence mask.
      thresh: inlier reprojection distance (the job's ``ransac`` key).
      method: 0 all-points least squares, 4 RANSAC, 8 least-median.
      generator, seed: where the hypotheses' point indices come from
        (:func:`draw_samples`).
      samples: (n_hypotheses, 4) or (N, n_hypotheses, 4) integer point
        indices to use instead of drawing any.
    """
    with torch.no_grad():
        p0 = p0.to(torch.float32)
        p1 = p1.to(torch.float32)
        mask = mask.to(torch.bool)
        maskf = mask.to(torch.float32)
        n_valid = mask.sum(dim=-1)

        if method == 0:
            H = _dlt(p0, p1, maskf)
            r = ((_apply_h(H, p0) - p1) ** 2).sum(dim=-1)
            inl = mask & (r < thresh * thresh)
            return HomographyResult(H, inl, inl.sum(dim=-1), n_valid >= 4)

        if samples is None:
            samples = draw_samples(mask, n_hypotheses, generator, seed)
        samples = samples.to(device=p0.device, dtype=torch.int64)
        nb = samples.shape[-2]

        # Shared normalization for hypothesis conditioning.
        Tp = _normalization(p0, maskf)
        Tq = _normalization(p1, maskf)
        p0n = _apply_h(Tp, p0)  # (..., K, 2)
        p1n = _apply_h(Tq, p1)

        def take(pts):  # (..., K, 2) -> (..., B, 4, 2)
            idx = samples.reshape(*samples.shape[:-2], nb * 4, 1)
            return torch.gather(pts, -2, idx.expand(*idx.shape[:-1], 2)).reshape(
                *samples.shape, 2
            )

        Hs = _solve_h4(take(p0n), take(p1n))  # (..., B, 3, 3)
        proj = _apply_h(Hs, p0n[..., None, :, :])  # (..., B, K, 2)
        residuals = ((proj - p1n[..., None, :, :]) ** 2).sum(dim=-1)
        residuals = torch.where(
            torch.isfinite(residuals), residuals,
            torch.full_like(residuals, math.inf),
        )

        # Normalized-space threshold: distances were scaled by Tq's scale.
        t2 = ((thresh * Tq[..., 0, 0]) ** 2)[..., None, None]

        if method == 8:  # least-median of squares
            med = _median_of_valid(residuals, mask)
            best = med.argmin(dim=-1)
            ok_hyp = torch.isfinite(torch.gather(med, -1, best[..., None])[..., 0])
        else:  # RANSAC
            counts = ((residuals < t2) & mask[..., None, :]).sum(dim=-1)
            best = counts.argmax(dim=-1)
            ok_hyp = torch.gather(counts, -1, best[..., None])[..., 0] >= 4

        k = residuals.shape[-1]
        best_res = torch.gather(
            residuals, -2, best[..., None, None].expand(*best.shape, 1, k)
        )[..., 0, :]
        inl = mask & (best_res < t2[..., 0])
        # Refit on the winning inliers in original coordinates.
        H = _dlt(p0, p1, inl.to(torch.float32))
        r = ((_apply_h(H, p0) - p1) ** 2).sum(dim=-1)
        inl_final = mask & (r < thresh * thresh)
        n_inl = inl_final.sum(dim=-1)
        ok = ok_hyp & (n_inl >= 4) & (n_valid >= 4)
        return HomographyResult(H, inl_final, n_inl, ok)
