"""The TV-L1 level solve on the GPU: wrapper of the hand-written CUDA kernel
(``csrc/tvl1_level.cu``), its plain PyTorch version, and the coarse-to-fine
solve that runs a kernel at every pyramid level (this one, or the blocked
kernel of ``ops/tvl1_blocked_cuda.py`` for the large levels).

:func:`tvl1_level_solve` solves one whole level for a batch: given
``(i0, i1, u1, u2)`` it returns ``(u1, u2, iterations run per image)``. On a
CUDA tensor it launches the kernel or raises; a CPU tensor takes
:func:`tvl1_level_solve_plain`, which computes the same function from the
plain solver's ``_iteration`` and ``warp_backward``. ``gamma != 0`` is not
solved by the kernel (``ops.tvl1.tvl1_flow_batched`` routes it to the plain
solver).

The library is compiled at the first CUDA call (``ops/_build.py``), so
importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops import _build
from optflow_tpu_torch.ops.tvl1 import level_solve_plain, solve_pyramid

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("tvl1_level")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # pointers and the stream are Python ints: without argtypes ctypes
        # would pass them as 32-bit ints and cut them
        lib.tvl1_level_solve.argtypes = (
            [ptr] * 9 + [i32] * 5 + [f32] * 4 + [ptr]
        )
        lib.tvl1_level_solve.restype = i32
        lib.tvl1_level_scratch_floats.argtypes = [i32, i32, i32]
        lib.tvl1_level_scratch_floats.restype = ctypes.c_longlong
        lib.tvl1_error_string.argtypes = [i32]
        lib.tvl1_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(i0, i1, u1, u2, params: TVL1Params) -> None:
    if params.gamma != 0.0:
        raise ValueError(
            "tvl1_level_solve does not solve gamma != 0; use "
            "ops.tvl1.tvl1_flow_batched, which takes the plain solver"
        )
    if i0.dim() != 3:
        raise ValueError(f"expected (N, H, W) tensors, got {tuple(i0.shape)}")
    for name, t in (("i0", i0), ("i1", i1), ("u1", u1), ("u2", u2)):
        if t.shape != i0.shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, i0 {tuple(i0.shape)}"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != i0.device:
            raise ValueError(f"{name} is on {t.device}, i0 on {i0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h, w = i0.shape
    if n < 1 or n > 65535 or h < 2 or w < 2:
        raise ValueError(f"unsupported level shape {tuple(i0.shape)}")


def tvl1_level_solve_plain(
    i0: torch.Tensor,  # (N, H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`tvl1_level_solve`: same arguments,
    same result, on whatever device the tensors lie. The tests and the
    kernel's on-card comparison use it."""
    _check_inputs(i0, i1, u1, u2, params)
    a, b, _, iters = level_solve_plain(i0, i1, u1, u2, params)
    return a, b, iters


def tvl1_level_solve(
    i0: torch.Tensor,  # (N, H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve one pyramid level for a batch of images.

    ``params.warps`` sweeps, each a backward warp by the current flow and up
    to ``params.iterations`` primal-dual updates; with ``params.epsilon > 0``
    each image stops once its own sum of squared updates is
    ``<= epsilon^2 * H * W``. Returns ``(u1, u2, iters)``: the new flow and
    the iterations each image ran, ``(N,)`` int32, summed over the sweeps.

    CUDA tensors launch the kernel on the current stream without
    synchronising (``tvl1_level_solve.launches`` counts these calls) or
    raise; CPU tensors take the plain version."""
    if not i0.is_cuda:
        return tvl1_level_solve_plain(i0, i1, u1, u2, params)
    _check_inputs(i0, i1, u1, u2, params)
    lib = _library()
    n, h, w = i0.shape
    dev = i0.device
    use_eps = params.epsilon > 0
    thresh = params.epsilon * params.epsilon * h * w if use_eps else -1.0
    with torch.cuda.device(dev):
        u1_out = torch.empty_like(u1)
        u2_out = torch.empty_like(u2)
        iters = torch.empty(n, dtype=torch.int32, device=dev)
        scratch = torch.empty(
            lib.tvl1_level_scratch_floats(n, h, w), dtype=torch.float32,
            device=dev,
        )
        err = torch.empty(
            max(1, n * params.iterations), dtype=torch.float32, device=dev
        )
        code = lib.tvl1_level_solve(
            i0.data_ptr(), i1.data_ptr(), u1.data_ptr(), u2.data_ptr(),
            u1_out.data_ptr(), u2_out.data_ptr(), iters.data_ptr(),
            scratch.data_ptr(), err.data_ptr(),
            n, h, w, int(params.warps), int(params.iterations),
            float(params.lambda_ * params.theta), float(params.theta),
            float(params.tau / params.theta), float(thresh),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"tvl1_level_solve: CUDA error {code}: "
            f"{lib.tvl1_error_string(code).decode()}"
        )
    tvl1_level_solve.launches += 1
    return u1_out, u2_out, iters


tvl1_level_solve.launches = 0


# Padded pixels above which a level goes to the blocked kernel: the JAX
# package's fused-kernel budget, _fused_px_budget(8) of
# optflow_tpu/ops/tvl1_pallas.py:116 (int(110 MiB * 0.92) // 250 B per pixel),
# kept so that the same levels take the counterpart kernels in both packages.
# It is a size of the TPU's on-chip memory, not of this card.
FUSED_PX_BUDGET = 424463


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def takes_blocked_kernel(h: int, w: int) -> bool:
    """Whether an ``h x w`` level is solved by the blocked kernel
    (ops/tvl1_blocked_cuda.py) rather than :func:`tvl1_level_solve`: the JAX
    package's rule, on its padded canvas of 8 rows x 128 columns."""
    return _round_up(h, 8) * _round_up(w, 128) > FUSED_PX_BUDGET


def _kernel_level_solver(i0, i1, u1, u2, params, u3):
    if takes_blocked_kernel(*i0.shape[-2:]):
        from optflow_tpu_torch.ops.tvl1_blocked_cuda import (
            tvl1_blocked_level_solve,
        )

        a, b, iters = tvl1_blocked_level_solve(i0, i1, u1, u2, params)
    else:
        a, b, iters = tvl1_level_solve(i0, i1, u1, u2, params)
    return a, b, u3, iters


def tvl1_flow_batched_cuda(
    i0s: torch.Tensor,  # (N, H, W)
    i1s: torch.Tensor,
    params: TVL1Params = TVL1Params(),
    init_flow: Optional[torch.Tensor] = None,  # (N, H, W, 2)
) -> torch.Tensor:
    """Full coarse-to-fine TV-L1 flow of a batch with a level kernel at
    every pyramid level: the blocked kernel where
    :func:`takes_blocked_kernel`, else :func:`tvl1_level_solve`. Nothing is
    read back inside the solve; the per-level iteration counts are kept on
    the device (``ops.tvl1.get_last_iteration_stats``)."""
    return solve_pyramid(i0s, i1s, params, init_flow, _kernel_level_solver)
