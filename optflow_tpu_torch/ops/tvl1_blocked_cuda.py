"""The blocked TV-L1 level solve on the GPU: wrapper of the hand-written CUDA
kernel (``csrc/tvl1_blocked.cu``) and its plain PyTorch version.

:func:`tvl1_blocked_level_solve` is the port's counterpart of the JAX
package's blocked level kernel (``_blocked_level_fn``), as ``tvl1_chunk`` is
its chunk kernel's: it has the signature of
``ops.tvl1_cuda.tvl1_level_solve`` and solves the same level with that
kernel's exit rule, an image's epsilon exit tested after every ``k``-th
iteration of a sweep, on that iteration's error. No path of the package
selects it: every pyramid level takes ``tvl1_level_solve``, the exact
per-iteration exit. On a CUDA tensor it is one cooperative launch of the
persistent level grid (``csrc/tvl1_grid.cuh``) with the exit period ``k``,
or raises; a CPU tensor takes :func:`tvl1_blocked_level_solve_plain`, which
applies the same exit rule on whole images.

The library is compiled at the first CUDA call (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops import _build
from optflow_tpu_torch.ops.tvl1 import level_solve_plain
from optflow_tpu_torch.ops.tvl1_cuda import _check_inputs, bind_grid, launch_grid

# The exit period: the JAX package's _BLOCKED_K
# (optflow_tpu/ops/tvl1_pallas.py:738), and the most the library takes.
BLOCKED_K = 16

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    with _build.lock:
        if _lib is None:
            lib = _build.load_library("tvl1_blocked")
            bind_grid(lib, "tvl1_blocked_level_solve", extra_ints=1)
            if lib.tvl1_blocked_max_k() != BLOCKED_K:
                raise RuntimeError(
                    f"csrc/tvl1_blocked.cu allows k <= {lib.tvl1_blocked_max_k()}"
                    f", the wrapper expects {BLOCKED_K}"
                )
            _lib = lib
    return _lib


def _check_k(k: int) -> None:
    if not 1 <= k <= BLOCKED_K:
        raise ValueError(
            f"k must be in 1..{BLOCKED_K} (the range of "
            f"csrc/tvl1_blocked.cu), got {k}"
        )


def tvl1_blocked_level_solve_plain(
    i0: torch.Tensor,  # (N, H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
    k: int = BLOCKED_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`tvl1_blocked_level_solve`: the plain
    level solve with the exit tested every ``k`` iterations on the last
    iteration's error. With ``epsilon = 0`` it is the plain level solve."""
    _check_inputs(i0, i1, u1, u2, params)
    _check_k(k)
    a, b, _, iters = level_solve_plain(i0, i1, u1, u2, params, exit_every=k)
    return a, b, iters


@_build.counted_launches
def tvl1_blocked_level_solve(
    i0: torch.Tensor,  # (N, H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
    k: int = BLOCKED_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve one pyramid level for a batch of images with the exit tested
    every ``k`` iterations.

    ``params.warps`` sweeps, each a backward warp by the current flow and up
    to ``params.iterations`` primal-dual updates; with ``params.epsilon > 0``
    an image skips the rest of a sweep once the sum of squared updates of
    its ``k``-th, ``2k``-th, ... iteration is ``<= epsilon^2 * H * W``.
    Returns ``(u1, u2, iters)``: the new flow and the iterations each image
    ran, ``(N,)`` int32, summed over the sweeps.

    CUDA tensors launch the kernel on the current stream without
    synchronising (``tvl1_blocked_level_solve.launches`` counts these calls;
    ``last_work`` and ``last_steps`` keep what the calling thread's last call
    computed and the steps it took, as ``tvl1_level_solve``'s do) or raise;
    CPU tensors take the plain version."""
    if not i0.is_cuda:
        return tvl1_blocked_level_solve_plain(i0, i1, u1, u2, params, k)
    _check_k(k)
    u1_out, u2_out, iters, work, steps = launch_grid(
        _library(), "tvl1_blocked_level_solve", i0, i1, u1, u2, params,
        int(k), int(k),
    )
    tvl1_blocked_level_solve.count_launch(work, steps)
    return u1_out, u2_out, iters

