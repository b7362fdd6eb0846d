"""One work count for the TV-L1 solve, and the card's published peaks.

Every roofline share of the port (``chip_smoke.py``'s kernels line, the
benches' ``mfu`` and rows) reads the work from here, so a share means the
same whatever implements the function: the float operations and bytes that
the function needs on these inputs, never what a design adds (the apron a
tiled kernel recomputes, index arithmetic, iterations run by speculation past
an exit). Where an exit ends a loop early, the work is that of the
iterations counted to the exit (``ops.tvl1.get_last_iteration_stats``,
which the kernel path fills with its exit's counts, equal to the plain
solver's).

The JAX package's counts are not used: ``ops/tvl1_pallas.py``'s 82 a
pixel-iteration is its TPU kernel's own body (selects and compares of the
fused layout included), and ``bench_matrix.py``'s 70 an estimate; both count
a design, and both were set against a TPU's peak.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

# published peaks of one H100 SXM (NVIDIA data sheet), at its full power
# limit of 700 W: device memory rate and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Float operations per pixel that the function needs, tallied from the
# arithmetic of csrc/tvl1_level.cu with the convention of the peak above:
# mul, add/sub, negate, compare, min/max, floor, div and sqrt count 1 each,
# a multiply-add 2. Index arithmetic and border tests are integer work and
# are not counted; the apron the tiled kernel recomputes is the design's
# overhead, not the function's, and is not counted either.
#
# One primal-dual iteration:
#   grad = a*a + b*b                                   3
#   rho = rho_c + a*u1 + b*u2                          4
#   t = l_t*grad                                       1
#   rho < -t, rho > t, grad > eps (one negate)         4
#   threshold step, its longest branch:
#     fi = -rho / max(grad, eps); d = fi*(a, b)        5
#   div p, two fields: 2 differences + 1 add each      6
#   u_new = (u + d) + theta*div, two fields            6
#   sum of |u_new - u|^2: 2 sub, 2 mul, 2 add          6
#   forward differences of u_new                       4
#   1 + taut*sqrt(ux*ux + uy*uy), two fields          12
#   p_new = (p + taut*du) / norm, four fields         12
ITER_FLOPS_PER_PX = 3 + 4 + 1 + 4 + 5 + 6 + 6 + 6 + 4 + 12 + 12  # = 63
# One warp sweep:
#   x + u1, y + u2                                     2
#   clamp to the image (max, min), two axes            4
#   x0 = min(floor(x), w - 2), two axes                4
#   fx, fy                                             2
#   four hat weights t*t*(1.5*t - 2.5) + 1 at 5 each,
#     and 1 - fx, 1 - fy                              22
#   1 / ((wx0 + wx1)*(wy0 + wy1))                      4
#   three 2x2 gathers (i1, i1x, i1y): two rows of
#     3, their blend 3, the renormalisation 1         30
#   rho_c = i1w - i1wx*u1 - i1wy*u2 - i0               5
WARP_FLOPS_PER_PX = 2 + 4 + 4 + 2 + 22 + 4 + 30 + 5  # = 73
# The gradient: 0.5*(r - l) and 0.5*(d - u)
GRAD_FLOPS_PER_PX = 4


class Work(NamedTuple):
    """What a function needs: float operations, bytes moved (each input
    read once, each output written once), and the pixel-iterations counted
    (one primal-dual update of one pixel)."""

    flops: float
    bytes: float
    px_iterations: float


def level_flops(n, h, w, warps, total_iters) -> float:
    """Float operations of one level solve of ``n`` images of ``h x w``:
    the gradient and ``warps`` warp sweeps of every image, and
    ``total_iters`` primal-dual iterations (summed over the images)."""
    return h * w * (ITER_FLOPS_PER_PX * total_iters
                    + n * (WARP_FLOPS_PER_PX * warps + GRAD_FLOPS_PER_PX))


def level_work(n, h, w, warps, total_iters) -> Work:
    """One level solve: inputs i0, i1, u1, u2 read once, outputs u1, u2 and
    the iteration counts written once."""
    return Work(level_flops(n, h, w, warps, total_iters),
                6 * 4 * n * h * w + 4 * n, h * w * total_iters)


def chunk_work(n, h, w, blocks, total_iters) -> Work:
    """One chunk call: ro (3 planes) and the state (6) read once, the new
    state (6) and the per-block errors written once; the iterations these
    images ran (``total_iters``, summed over the images)."""
    return Work(ITER_FLOPS_PER_PX * h * w * total_iters,
                15 * 4 * n * h * w + 4 * n * blocks, h * w * total_iters)


def pyramid_work(stats: Sequence, warps: int) -> Work:
    """A coarse-to-fine solve from its per-level counts, ``[((h, w),
    iterations per image (N,)), ...]`` as ``get_last_iteration_stats``
    returns them (any order): every level's gradient, ``warps`` sweeps and
    counted iterations; the two input stacks read once and the flow written
    once at the finest level (the largest), ``16 * N`` bytes a pixel. The
    pyramid's resampling, a few operations a pixel a level, is left out."""
    flops = px_iters = 0.0
    finest = 0
    n = 0
    for (h, w), iters in stats:
        counts = [int(c) for c in iters]
        n = len(counts)
        flops += level_flops(n, h, w, warps, sum(counts))
        px_iters += h * w * sum(counts)
        finest = max(finest, h * w)
    return Work(flops, 16.0 * n * finest, px_iters)


def bound_seconds(work: Work) -> Tuple[float, str]:
    """The least time the card could take for ``work``: the larger of its
    bytes over the memory rate and its operations over the float32 rate,
    and which of the two it is (``"bytes"`` or ``"operations"``)."""
    t_bytes = work.bytes / PEAK_BYTES_PER_S
    t_ops = work.flops / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_bound_ms(n, h, w, warps, total_iters) -> Tuple[float, str]:
    """:func:`bound_seconds` of :func:`level_work`, in ms."""
    t, by = bound_seconds(level_work(n, h, w, warps, total_iters))
    return t * 1e3, by


def chunk_bound_ms(n, h, w, blocks, total_iters) -> Tuple[float, str]:
    """:func:`bound_seconds` of :func:`chunk_work`, in ms."""
    t, by = bound_seconds(chunk_work(n, h, w, blocks, total_iters))
    return t * 1e3, by


def share(work: Work, seconds: float) -> Tuple[float, str]:
    """The roofline share of ``work`` done in ``seconds`` on the card: the
    least time (:func:`bound_seconds`) over the time taken, and the bound
    that sets it. A share above 1.0 raises: it means the count is wrong,
    not that the card is fast."""
    least, by = bound_seconds(work)
    s = least / seconds
    if s > 1.0:
        raise ValueError(
            f"roofline share {s} > 1.0 ({by}: {least} s of least time in "
            f"{seconds} s): the work count is wrong")
    return s, by
