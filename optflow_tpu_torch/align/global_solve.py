"""Global stack alignment from accumulated point matches.

The reference emits point matches to the Janelia Render service and leaves
the global solve to external tooling (SURVEY.md §1: "the system's
parameter server"); here the solve runs in-process. Given the match
collection (Render schema, as produced by the engine's sinks), estimate one
transform per section (group) that aligns the whole stack:

- translation model: one 2D offset per section. Residual for a match
  between sections a and b at points (p, q): (p + t_a) - (q + t_b). The
  normal equations form a graph Laplacian over the section graph (pairs at
  z-distance <= 3, docs/example_gen_cross:1) which is solved by
  Jacobi-preconditioned conjugate gradient on the device; its matvec is a
  gather and two ``index_add_`` scatters over the match edges.
- affine model: 6 parameters per section, same edge structure, with a
  regularization pulling each affine toward identity (gauge fixing plus
  conditioning for weakly-connected sections). The residual is linear in
  the parameters, so J x and J^T y are written out as gathers and
  ``index_add_`` scatters.

The first section is pinned to the identity to fix the global gauge. The
device solve computes in float32; the edge arrays are host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class AlignmentResult:
    group_ids: List[str]
    # per-section 2x3 affines mapping section coords -> global coords
    transforms: np.ndarray  # (Z, 2, 3)
    residual: float  # RMS match residual after alignment


def _identity(z: int) -> np.ndarray:
    return np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (z, 1, 1))


def _collect_edges(matches: Sequence[dict]):
    """Flatten a Render-schema match collection into edge arrays.

    Returns (group_ids, a_idx (M,), b_idx (M,), p (M,2), q (M,2), w (M,)),
    group ids numbered in order of first appearance (p before q). Matches
    of weight <= 0 are the reference's dummy matches (src/optflow.cpp:
    560-569) and are left out."""
    groups: Dict[str, int] = {}
    a_idx, b_idx, ps, qs, ws = [], [], [], [], []
    for rec in matches:
        ga = str(rec["pGroupId"])
        gb = str(rec["qGroupId"])
        for g in (ga, gb):
            if g not in groups:
                groups[g] = len(groups)
        m = rec["matches"]
        w = np.asarray(m["w"], np.float64).reshape(-1)
        keep = ~(w <= 0)  # NaN weights are kept, as a "w <= 0" test keeps them
        n = int(keep.sum())
        if n == 0:
            continue
        k = len(w)
        p = np.asarray([m["p"][0][:k], m["p"][1][:k]], np.float64)[:, keep]
        q = np.asarray([m["q"][0][:k], m["q"][1][:k]], np.float64)[:, keep]
        a_idx.append(np.full(n, groups[ga], np.int32))
        b_idx.append(np.full(n, groups[gb], np.int32))
        ps.append(p.T)
        qs.append(q.T)
        ws.append(w[keep])
    group_ids = list(groups)  # insertion order = index order

    def cat(parts, dtype, shape):
        if not parts:
            return np.zeros(shape, dtype)
        return np.concatenate(parts).astype(dtype)

    return (
        group_ids,
        cat(a_idx, np.int32, (0,)),
        cat(b_idx, np.int32, (0,)),
        cat(ps, np.float32, (0, 2)),
        cat(qs, np.float32, (0, 2)),
        cat(ws, np.float32, (0,)),
    )


def _cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    M_inv: torch.Tensor,
    iters: int,
    tol: float,
) -> torch.Tensor:
    """Jacobi-preconditioned conjugate gradient on ``b``'s device. It stops
    when ``i >= iters`` or ``sum(r * r) <= tol``, tested before every
    iteration (one scalar read a step)."""
    x = torch.zeros_like(b)
    r = b
    z = M_inv * r
    p = z
    rz = torch.sum(r * z)
    i = 0
    while i < iters and float(torch.sum(r * r)) > tol:
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv * r
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-12)
        p = z + beta * p
        rz = rz_new
        i += 1
    return x


def _rms(res: np.ndarray) -> float:
    return float(np.sqrt((res**2).sum(axis=1).mean()))


def solve_translation_alignment(
    matches: Sequence[dict],
    iters: int = 200,
    tol: float = 1e-6,
    device="cuda",
) -> AlignmentResult:
    """Per-section translations minimizing sum w ||(p + t_a) - (q + t_b)||^2
    with t_0 = 0, solved on ``device``."""
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    if z == 0 or len(w) == 0:
        return AlignmentResult(group_ids, np.zeros((z, 2, 3), np.float32), 0.0)

    dev = torch.device(device)
    a = torch.from_numpy(a_idx.astype(np.int64)).to(dev)
    b = torch.from_numpy(b_idx.astype(np.int64)).to(dev)
    wt = torch.from_numpy(w).to(dev)[:, None]
    d = torch.from_numpy(q - p).to(dev)  # residual target: t_a - t_b = q - p

    # Gauge fixing: a quadratic penalty pinning t_0 ~ 0 keeps the operator
    # symmetric positive definite (a replaced row would break CG).
    pin = 2.0 * float(np.sum(w)) + 1.0

    def scatter(vals):  # sum over edges of +vals at a, -vals at b
        out = torch.zeros((z,) + vals.shape[1:], dtype=vals.dtype, device=dev)
        out.index_add_(0, a, vals)
        out.index_add_(0, b, -vals)
        return out

    # Laplacian matvec: (L t)_i = sum_edges w * (t_a - t_b) contributions.
    def matvec(t):  # t: (Z, 2)
        out = scatter(wt * (t[a] - t[b]))
        out[0] += pin * t[0]
        return out

    rhs = scatter(wt * d)
    deg = torch.zeros(z, dtype=torch.float32, device=dev)
    deg.index_add_(0, a, wt[:, 0])
    deg.index_add_(0, b, wt[:, 0])
    deg[0] += pin
    M_inv = (1.0 / torch.clamp(deg, min=1e-9))[:, None].expand(z, 2)

    t_np = _cg(matvec, rhs, M_inv, iters, tol).cpu().numpy()

    transforms = _identity(z)
    transforms[:, :, 2] = t_np
    res = (p + t_np[a_idx]) - (q + t_np[b_idx])
    return AlignmentResult(group_ids, transforms, _rms(res))


def solve_affine_alignment(
    matches: Sequence[dict],
    reg_lambda: float = 1e-3,
    iters: int = 400,
    tol: float = 1e-8,
    device="cuda",
) -> AlignmentResult:
    """Per-section affines A_z (2x3) minimizing
    sum w ||A_a(p) - A_b(q)||^2 + reg * sum ||A_z - I||^2, A_0 pinned,
    solved on ``device``."""
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    if z == 0 or len(w) == 0:
        return AlignmentResult(group_ids, _identity(z), 0.0)

    dev = torch.device(device)
    a = torch.from_numpy(a_idx.astype(np.int64)).to(dev)
    b = torch.from_numpy(b_idx.astype(np.int64)).to(dev)
    wt = torch.from_numpy(w).to(dev)[:, None]
    pt = torch.from_numpy(p).to(dev)
    qt = torch.from_numpy(q).to(dev)
    ones = torch.ones((len(w), 1), dtype=torch.float32, device=dev)
    ph_p = torch.cat([pt, ones], dim=1)  # (M, 3) homogeneous points
    ph_q = torch.cat([qt, ones], dim=1)

    # x: (Z, 6) = [a11, a12, tx, a21, a22, ty], stored as delta from
    # identity; X_z = x_z reshaped (2, 3) moves a point by X_z (pt, 1)
    def delta(x, pts_h, idx):
        return torch.einsum("mij,mj->mi", x[idx].reshape(-1, 2, 3), pts_h)

    def residuals(x):  # (M, 2)
        return (pt + delta(x, ph_p, a)) - (qt + delta(x, ph_q, b))

    def jx(x):  # the residual's linear part
        return delta(x, ph_p, a) - delta(x, ph_q, b)

    def jty(y):  # y: (M, 2) -> (Z, 6)
        out = torch.zeros((z, 6), dtype=torch.float32, device=dev)
        out.index_add_(0, a, (y[:, :, None] * ph_p[:, None, :]).reshape(-1, 6))
        out.index_add_(0, b, -(y[:, :, None] * ph_q[:, None, :]).reshape(-1, 6))
        return out

    # Normal equations (the problem is linear, so one CG solve is exact).
    pin = 2.0 * float(np.sum(w)) + 1.0

    def matvec(x):
        out = jty(wt * jx(x)) + reg_lambda * x
        # symmetric gauge penalty pinning section 0's delta toward 0
        out[0] += pin * x[0]
        return out

    rhs = jty(-wt * (pt - qt))
    M_inv = torch.ones((z, 6), dtype=torch.float32, device=dev)
    x = _cg(matvec, rhs, M_inv, iters, tol)

    transforms = _identity(z) + x.cpu().numpy().reshape(z, 2, 3)
    return AlignmentResult(group_ids, transforms, _rms(residuals(x).cpu().numpy()))
