"""Z-block Schur-complement alignment solve — the direct solve of the stack
alignment problem for long stacks.

The production pair graph couples sections only at z-distance <= 3
(docs/example_gen_cross:1, support_scripts/gen_cross_file_list.py:23-27),
so the normal equations of the global alignment problem are (nearly)
block-banded along z:

1. Sections are ordered by z and partitioned into contiguous blocks; a
   thin vertex separator per internal boundary absorbs every cross-block
   edge (any edge endpoint falling in a later block is promoted into the
   separator, so the construction is correct for arbitrary graphs, not
   just banded ones — it is merely *efficient* when the graph is banded).
2. The dense per-block normal matrices are assembled on the host in
   float64, vectorised over the edges: the edges' k x k products are summed
   per section pair and scattered once per pair.
3. On the device, in float64 (``_SOLVE_DTYPE``), the blocks are
   Cholesky-factorised in one batched call, the separator (Schur) system
   S = A_SS - sum_k A_SI A_II^-1 A_IS is reduced over the blocks and solved
   by Cholesky, and the interiors back-substitute in one batched call.

Models: ``translation`` (1 parameter per section per component) and
``affine`` (3 parameters; the x- and y-rows of a 2x3 affine share the same
per-edge coefficients (x, y, 1), so both components solve against ONE
factorization with two right-hand sides).

Single process: the blocks are not sharded over devices.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from optflow_tpu_torch.align.global_solve import (
    AlignmentResult,
    _collect_edges,
    _identity,
    _rms,
)
from optflow_tpu_torch.utils.metrics import StageTimer


# The factorisations and solves run in float64, not the JAX package's
# float32, for both models: on a chain of 9,604 sections (38 blocks of 256)
# a float32 solve lands 5.5 px (translation) and 37 px (affine) from the
# exact least-squares optimum of the same equations, float64 within 1e-4 px
# (chip_smoke.py's align phase reads both).
_SOLVE_DTYPE = torch.float64


def _z_order(group_ids: List[str]) -> np.ndarray:
    """Stable section order by numeric group id (Render group ids are z
    values as strings) with a lexicographic fallback."""
    def key(g):
        try:
            return (0, float(g), g)
        except ValueError:
            return (1, 0.0, g)

    order = sorted(range(len(group_ids)), key=lambda i: key(group_ids[i]))
    return np.asarray(order, np.int64)


def _partition(
    zpos_a: np.ndarray,
    zpos_b: np.ndarray,
    z: int,
    block_sections: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Assign each section (by z position) a block id, then promote the
    later endpoint of every cross-block edge into the separator.

    Returns (block_of_section (Z,), is_separator (Z,) bool) in z order.
    """
    nb = max(1, -(-z // block_sections))
    block = np.minimum(np.arange(z) // block_sections, nb - 1)
    is_sep = np.zeros(z, bool)
    # promoting an endpoint can never create new cross-interior edges, so
    # one pass suffices
    cross = block[zpos_a] != block[zpos_b]
    later = np.where(zpos_a > zpos_b, zpos_a, zpos_b)
    is_sep[later[cross]] = True
    return block, is_sep


class _Slots(NamedTuple):
    """Where each section (in z order) sits in the assembled system: ``sep``
    True for a separator section; ``blk`` its block (interiors); ``off``
    the offset of its k rows, in its block's interior rows or in the
    separator rows."""

    sep: np.ndarray
    blk: np.ndarray
    off: np.ndarray
    int_count: np.ndarray  # interior sections per block
    ns: int  # separator sections


def _slots(block: np.ndarray, is_sep: np.ndarray, k: int) -> _Slots:
    nb = int(block.max()) + 1
    interior = ~is_sep
    # rank of an interior section among its block's interiors: blocks are
    # contiguous in z, so a running count less the count at the block start
    run = np.cumsum(interior) - interior
    start = np.searchsorted(block, np.arange(nb))
    int_rank = run - run[start][block]
    sep_rank = np.cumsum(is_sep) - is_sep
    off = np.where(is_sep, sep_rank, int_rank) * k
    int_count = np.bincount(block[interior], minlength=nb)
    return _Slots(is_sep, block, off, int_count, int(is_sep.sum()))


def _assemble(za, zb, ca, cb, d, w, slots: _Slots, k: int):
    """The dense normal equations, in float64: (A_II (nb, ni, ni), A_IS (nb,
    ni, nss), A_SS (nss, nss), r_I (nb, ni, 2), r_S (nss, 2)), without the
    regularisation. An edge e between z positions a and b with
    coefficient rows ca, cb (k,) adds w ca ca^T at (a, a), -w ca cb^T at
    (a, b), its transpose at (b, a), w cb cb^T at (b, b), and w ca d^T, -w
    cb d^T to the right-hand sides of a and b. Each product is rounded to
    float32, as the per-edge loop computes it, then summed in float64:
    first over the edges of each section pair, then once per pair into the
    blocks. The (separator, interior) blocks are the transposes of A_IS and
    are not stored."""
    nb = len(slots.int_count)
    ni = int(slots.int_count.max()) * k
    nss = slots.ns * k
    A_II = np.zeros((nb, ni, ni), np.float64)
    A_IS = np.zeros((nb, ni, nss), np.float64)
    A_SS = np.zeros((nss, nss), np.float64)
    r_I = np.zeros((nb, ni, 2), np.float64)
    r_S = np.zeros((nss, 2), np.float64)

    z = len(slots.sep)
    pair = za.astype(np.int64) * z + zb
    pairs, inv = np.unique(pair, return_inverse=True)
    pa, pb = pairs // z, pairs % z
    n_pairs = len(pairs)

    def per_pair(vals):  # (M,) float32 -> (P,) float64 sums
        return np.bincount(inv, weights=vals.astype(np.float64),
                           minlength=n_pairs)

    def outer_sums(c1, c2):  # sum of fl32(w * fl32(c1_j c2_l)) -> (P, k, k)
        out = np.empty((n_pairs, k, k), np.float64)
        for j in range(k):
            for col in range(k):
                out[:, j, col] = per_pair(w * (c1[:, j] * c2[:, col]))
        return out

    def rhs_sums(c):  # sum of fl32(fl32(w c_j) d_c) -> (P, k, 2)
        out = np.empty((n_pairs, k, 2), np.float64)
        for j in range(k):
            wc = w * c[:, j]
            for comp in range(2):
                out[:, j, comp] = per_pair(wc * d[:, comp])
        return out

    s_ab = outer_sums(ca, cb)
    blocks = (
        (pa, pa, outer_sums(ca, ca)),
        (pa, pb, -s_ab),
        (pb, pa, -np.transpose(s_ab, (0, 2, 1))),
        (pb, pb, outer_sums(cb, cb)),
    )
    jj, ll = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    for zi, zj, vals in blocks:
        si, sj = slots.sep[zi], slots.sep[zj]
        rows = slots.off[zi][:, None, None] + jj  # (P, k, k)
        cols = slots.off[zj][:, None, None] + ll
        blk = np.broadcast_to(slots.blk[zi][:, None, None], rows.shape)
        s = ~si & ~sj
        np.add.at(A_II, (blk[s], rows[s], cols[s]), vals[s])
        s = ~si & sj
        np.add.at(A_IS, (blk[s], rows[s], cols[s]), vals[s])
        s = si & sj
        np.add.at(A_SS, (rows[s], cols[s]), vals[s])

    comp = np.arange(2)
    for zi, vals in ((pa, rhs_sums(ca)), (pb, -rhs_sums(cb))):
        si = slots.sep[zi]
        rows = np.broadcast_to(
            slots.off[zi][:, None, None] + np.arange(k)[:, None], vals.shape)
        cc = np.broadcast_to(comp, vals.shape)
        blk = np.broadcast_to(slots.blk[zi][:, None, None], vals.shape)
        np.add.at(r_I, (blk[~si], rows[~si], cc[~si]), vals[~si])
        np.add.at(r_S, (rows[si], cc[si]), vals[si])
    return A_II, A_IS, A_SS, r_I, r_S


def solve_zblock_alignment(
    matches: Sequence[dict],
    model: str = "affine",
    block_sections: int = 256,
    reg_lambda: float = 1e-3,
    device="cuda",
    timer: Optional[StageTimer] = None,
) -> AlignmentResult:
    """Direct z-block Schur solve of the stack alignment problem.

    matches: Render-schema match collection (engine sink output).
    model: "translation" or "affine".
    device: where the factorisations and solves run; the assembly is host
      numpy.
    timer: collects the stages ``collect`` (edge arrays), ``assemble``
      (the dense system, host) and ``solve`` (upload, factorisations,
      solves, download; a device stage).
    """
    timer = timer if timer is not None else StageTimer()
    with timer.stage("collect"):
        group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    ident = _identity(z)
    if z == 0 or len(w) == 0:
        return AlignmentResult(group_ids, ident, 0.0)

    k = 1 if model == "translation" else 3
    order = _z_order(group_ids)
    rank = np.empty(z, np.int64)
    rank[order] = np.arange(z)  # section -> z position
    za = rank[a_idx]
    zb = rank[b_idx]

    block, is_sep = _partition(za, zb, z, block_sections)
    slots = _slots(block, is_sep, k)
    ni = int(slots.int_count.max()) * k
    nss = slots.ns * k

    # --- per-edge coefficient rows ---------------------------------------
    m = len(w)
    if model == "translation":
        ca = np.ones((m, 1), np.float32)
        cb = np.ones((m, 1), np.float32)
    else:
        ca = np.concatenate([p, np.ones((m, 1), np.float32)], axis=1)
        cb = np.concatenate([q, np.ones((m, 1), np.float32)], axis=1)
    d = (q - p).astype(np.float32)  # rhs target per edge (2 comps)

    with timer.stage("assemble"):
        A_II, A_IS, A_SS, r_I, r_S = _assemble(za, zb, ca, cb, d, w, slots, k)

    # regularization + gauge pin + identity rows for padded slots
    pin = 2.0 * float(np.sum(w)) + 1.0
    reg = reg_lambda if model == "affine" else 1e-9
    used = np.arange(ni)[None, :] < (slots.int_count * k)[:, None]  # (nb, ni)
    A_II[:, np.arange(ni), np.arange(ni)] += np.where(used, reg, 1.0)
    A_SS[np.arange(nss), np.arange(nss)] += reg
    # gauge: pin section 0 (original index) wherever it landed in z order
    z0 = int(rank[0])
    diag0 = slots.off[z0] + np.arange(k)
    if slots.sep[z0]:
        A_SS[diag0, diag0] += pin
    else:
        A_II[slots.blk[z0], diag0, diag0] += pin

    with timer.device_stage("solve", device):
        x_I, x_S = _schur_solve(A_II, A_IS, A_SS, r_I, r_S, device)

    # --- scatter back to (Z, 2, 3) transforms ------------------------------
    rows = slots.off[:, None] + np.arange(k)  # (Z, k) in z order
    sep = slots.sep
    src = np.empty((z, k, 2), x_I.dtype)
    src[sep] = x_S[rows[sep]]
    src[~sep] = x_I[slots.blk[~sep, None], rows[~sep]]
    delta = np.zeros((z, 2, k), np.float32)
    delta[order] = np.transpose(src, (0, 2, 1))
    transforms = ident.copy()
    if model == "translation":
        transforms[:, :, 2] += delta[:, :, 0]
    else:
        transforms += delta

    ph_p = np.concatenate([p, np.ones((m, 1), np.float32)], axis=1)
    ph_q = np.concatenate([q, np.ones((m, 1), np.float32)], axis=1)
    res = np.einsum("mij,mj->mi", transforms[a_idx], ph_p) - np.einsum(
        "mij,mj->mi", transforms[b_idx], ph_q
    )
    return AlignmentResult(group_ids, transforms, _rms(res))


def _schur_solve(A_II, A_IS, A_SS, r_I, r_S, device="cuda"):
    """Batched block Cholesky, Schur reduction and back-substitution of the
    assembled system on ``device``, in ``_SOLVE_DTYPE``. Returns (x_I (nb,
    ni, 2), x_S (nss, 2)) as host arrays."""
    dev = torch.device(device)

    def put(a):
        return torch.as_tensor(a, dtype=_SOLVE_DTYPE).to(dev)

    a_ii, a_is, a_ss, r_i, r_s = (put(t) for t in (A_II, A_IS, A_SS, r_I, r_S))
    nss = a_ss.shape[0]
    chol = torch.linalg.cholesky(a_ii)
    # X = A_II^-1 [A_IS | r_I]
    X = torch.cholesky_solve(torch.cat([a_is, r_i], dim=2), chol)
    if nss:
        s_con = torch.einsum("bij,bik->jk", a_is, X[:, :, :nss])
        r_con = torch.einsum("bij,bik->jk", a_is, X[:, :, nss:])
        x_s = torch.cholesky_solve(r_s - r_con,
                                   torch.linalg.cholesky(a_ss - s_con))
        bsub = r_i - torch.einsum("bij,jc->bic", a_is, x_s)
    else:
        x_s = r_s
        bsub = r_i
    x_i = torch.cholesky_solve(bsub, chol)
    return x_i.cpu().numpy(), x_s.cpu().numpy()
