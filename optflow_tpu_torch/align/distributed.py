"""Distributed global stack alignment: edge-sharded CG over a device mesh.

The single-device solver (align/global_solve.py) builds the match-graph
normal equations and runs preconditioned CG; for pod-scale stacks
(thousands of sections, millions of matches — the Sec26 VNC production
graph spans z=1..9604 at z-distance <= 3, docs/example_gen_cross:1) the
edge set is split over the mesh's ``pairs`` devices (padded with edges of
weight 0, which add nothing). Each CG matvec gathers and scatters on every
device's own edges into a partial ``(Z, 2)`` or ``(Z, 6)`` accumulator, and
the partials are summed onto the first device in device order — the
``psum``, deterministic. The per-section state is small: the CG runs on the
first device, and each matvec's vector is copied to every device.

Matvec per shard: diff = t[a] - t[b] on local edges; scatter-add into a
local (Z, 2) accumulator; the ordered sum -> the full matvec. The
preconditioners are the JAX package's: Jacobi for the translation model,
ones for the affine one.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from optflow_tpu_torch.align.global_solve import (
    AlignmentResult,
    _cg,
    _collect_edges,
    _identity,
    _rms,
)
from optflow_tpu_torch.dist.mesh import PairMesh, pairs_axis_devices, sum_in_order


def _edge_shards(devices, *arrays) -> List[tuple]:
    """Each edge array padded with zeros to a multiple of the device count
    (a zero weight makes a padding edge add nothing) and cut into one
    contiguous shard per device, uploaded there. Returns one tuple of
    tensors per device."""
    n = len(devices)
    m = len(arrays[0])
    per = -(-m // n)
    shards = []
    for d, dev in enumerate(devices):
        part = []
        for x in arrays:
            out = np.zeros((per,) + x.shape[1:], x.dtype)
            chunk = x[d * per: (d + 1) * per]
            out[: len(chunk)] = chunk
            part.append(torch.from_numpy(out).to(dev))
        shards.append(tuple(part))
    return shards


def _scatter(z: int, a, b, vals):
    """sum over edges of +vals at a, -vals at b, on the edges' device"""
    out = torch.zeros((z,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, a, vals)
    out.index_add_(0, b, -vals)
    return out


def solve_affine_alignment_sharded(
    matches: Sequence[dict],
    mesh: PairMesh,
    reg_lambda: float = 1e-3,
    iters: int = 400,
    tol: float = 1e-8,
) -> AlignmentResult:
    """Edge-sharded equivalent of solve_affine_alignment: each device owns
    an edge shard, the normal equations' matvec gathers and scatters on
    local edges, and the partial (Z, 6) accumulators are summed in device
    order (the same reduction as the translation solve)."""
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    if z == 0 or len(w) == 0:
        return AlignmentResult(group_ids, _identity(z), 0.0)

    devices = pairs_axis_devices(mesh)
    first = devices[0]
    shards = _edge_shards(devices, a_idx.astype(np.int64),
                          b_idx.astype(np.int64), w.astype(np.float32),
                          p.astype(np.float32), q.astype(np.float32))
    pin = 2.0 * float(np.sum(w)) + 1.0

    def homogeneous(pts):
        ones = torch.ones((pts.shape[0], 1), dtype=torch.float32,
                          device=pts.device)
        return torch.cat([pts, ones], dim=1)  # (m, 3)

    shards = [(a, b, ws, ps, qs, homogeneous(ps), homogeneous(qs))
              for a, b, ws, ps, qs in shards]

    # x: (Z, 6) delta-from-identity [a11, a12, tx, a21, a22, ty]. The x/y
    # parameter rows share the same per-edge coefficients (ph_a at a,
    # -ph_b at b), so the residual Jacobian factors.
    def jv_edges(x, s):
        a, b, _, _, _, ph_a, ph_b = s
        xa = x[a].reshape(-1, 2, 3)
        xb = x[b].reshape(-1, 2, 3)
        return (torch.einsum("mij,mj->mi", xa, ph_a)
                - torch.einsum("mij,mj->mi", xb, ph_b))  # (m, 2)

    def jt_edges(r, s):  # r: (m, 2) -> partial (Z, 6)
        a, b, _, _, _, ph_a, ph_b = s
        out = torch.zeros((z, 6), dtype=torch.float32, device=r.device)
        out.index_add_(0, a, (r[:, :, None] * ph_a[:, None, :]).reshape(-1, 6))
        out.index_add_(0, b,
                       -(r[:, :, None] * ph_b[:, None, :]).reshape(-1, 6))
        return out

    def matvec(x):
        parts = []
        for s in shards:
            xs = x.to(s[0].device)
            parts.append(jt_edges(s[2][:, None] * jv_edges(xs, s), s))
        out = sum_in_order(parts) + reg_lambda * x
        out[0] += pin * x[0]
        return out

    # residual at x = 0 with the identity baseline: r0 = p - q per edge
    rhs = sum_in_order([jt_edges(-s[2][:, None] * (s[3] - s[4]), s)
                        for s in shards])
    M_inv = torch.ones((z, 6), dtype=torch.float32, device=first)
    x_np = _cg(matvec, rhs, M_inv, iters, tol).cpu().numpy()

    transforms = _identity(z) + x_np.reshape(z, 2, 3)
    ph_p = np.concatenate([p, np.ones((len(w), 1), np.float32)], axis=1)
    ph_q = np.concatenate([q, np.ones((len(w), 1), np.float32)], axis=1)
    res = np.einsum("mij,mj->mi", transforms[a_idx], ph_p) - np.einsum(
        "mij,mj->mi", transforms[b_idx], ph_q
    )
    return AlignmentResult(group_ids, transforms, _rms(res))


def solve_translation_alignment_sharded(
    matches: Sequence[dict],
    mesh: PairMesh,
    iters: int = 200,
    tol: float = 1e-6,
) -> AlignmentResult:
    """Edge-sharded equivalent of solve_translation_alignment."""
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    if z == 0 or len(w) == 0:
        return AlignmentResult(group_ids, np.zeros((z, 2, 3), np.float32), 0.0)

    devices = pairs_axis_devices(mesh)
    first = devices[0]
    shards = _edge_shards(devices, a_idx.astype(np.int64),
                          b_idx.astype(np.int64), w.astype(np.float32),
                          (q - p).astype(np.float32))
    pin = 2.0 * float(np.sum(w)) + 1.0

    # every device holds its own edge shard; t is copied to each
    def matvec(t):
        parts = []
        for a, b, ws, _ in shards:
            ts = t.to(a.device)
            parts.append(_scatter(z, a, b, ws[:, None] * (ts[a] - ts[b])))
        out = sum_in_order(parts)
        out[0] += pin * t[0]
        return out

    rhs = sum_in_order([_scatter(z, a, b, ws[:, None] * d)
                        for a, b, ws, d in shards])
    deg = []
    for a, b, ws, _ in shards:
        part = torch.zeros(z, dtype=torch.float32, device=a.device)
        part.index_add_(0, a, ws)
        part.index_add_(0, b, ws)
        deg.append(part)
    deg = sum_in_order(deg)
    deg[0] += pin
    M_inv = (1.0 / torch.clamp(deg, min=1e-9))[:, None].expand(z, 2)
    t_np = _cg(matvec, rhs, M_inv, iters, tol).cpu().numpy()

    transforms = _identity(z)
    transforms[:, :, 2] = t_np
    res = (p + t_np[a_idx]) - (q + t_np[b_idx])
    return AlignmentResult(group_ids, transforms, _rms(res))
