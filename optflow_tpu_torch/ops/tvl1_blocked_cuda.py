"""The blocked TV-L1 level solve on the GPU: wrapper of the hand-written CUDA
kernel (``csrc/tvl1_blocked.cu``) and its plain PyTorch version.

:func:`tvl1_blocked_level_solve` has the signature of
``ops.tvl1_cuda.tvl1_level_solve`` and solves the same level, for levels too
large for that kernel's counterpart in the JAX package, with the JAX blocked
kernel's exit rule: an image's epsilon exit is tested after every ``k``-th
iteration of a sweep, on that iteration's error. On a CUDA tensor it is one
cooperative launch of the persistent level grid (``csrc/tvl1_grid.cuh``)
with the exit period ``k``, or raises; a CPU tensor takes
:func:`tvl1_blocked_level_solve_plain`, which applies the same exit rule on
whole images. :func:`tvl1_blocked_level_solve_per_chunk` is the design it
replaces (one launch per chunk of ``k`` iterations on tiles with a halo of
``k``), kept until ``ROADMAP.md`` deletes it so that the two can be timed in
turns and compared bit for bit; no path of the package selects it.

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
# (optflow_tpu/ops/tvl1_pallas.py:738). Also the most the replaced design's
# (32 + 2k) x (64 + 2k) x 36 B window allows in 227 KB of shared memory.
BLOCKED_K = 16

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("tvl1_blocked")
        bind_grid(lib, "tvl1_blocked_level_solve", extra_ints=1)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tvl1_blocked_level_solve_per_chunk.argtypes = (
            [ptr] * 10 + [i32] * 6 + [f32] * 4 + [ptr]
        )
        lib.tvl1_blocked_level_solve_per_chunk.restype = i32
        lib.tvl1_blocked_per_chunk_err_floats.argtypes = [i32] * 6
        lib.tvl1_blocked_per_chunk_err_floats.restype = ctypes.c_longlong
        lib.tvl1_blocked_error_string.argtypes = [i32]
        lib.tvl1_blocked_error_string.restype = ctypes.c_char_p
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
            f"k must be in 1..{BLOCKED_K} (the halo-extended tile must fit "
            f"one block's shared memory), got {k}"
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
    ``last_work`` and ``last_steps`` keep what the last call computed and the
    steps it took, as ``tvl1_level_solve``'s do) or raise; CPU tensors take
    the plain version."""
    if not i0.is_cuda:
        return tvl1_blocked_level_solve_plain(i0, i1, u1, u2, params, k)
    _check_k(k)
    u1_out, u2_out, iters, work, steps = launch_grid(
        _library(), "tvl1_blocked_level_solve", i0, i1, u1, u2, params,
        int(k), int(k),
    )
    tvl1_blocked_level_solve.launches += 1
    tvl1_blocked_level_solve.last_work = work
    tvl1_blocked_level_solve.last_steps = steps
    return u1_out, u2_out, iters


tvl1_blocked_level_solve.launches = 0
tvl1_blocked_level_solve.last_work = None
tvl1_blocked_level_solve.last_steps = None


def tvl1_blocked_level_solve_per_chunk(
    i0: torch.Tensor,  # (N, H, W) float32, on the card
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
    k: int = BLOCKED_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The replaced kernel, the same function as
    :func:`tvl1_blocked_level_solve`: one launch per chunk of ``k``
    iterations on tiles with a halo of ``k``. CUDA tensors only; its calls
    are not counted as launches of the blocked kernel."""
    if not i0.is_cuda:
        raise ValueError("the replaced blocked kernel runs on CUDA tensors")
    _check_inputs(i0, i1, u1, u2, params)
    _check_k(k)
    lib = _library()
    n, h, w = i0.shape
    dev = i0.device
    use_eps = params.epsilon > 0
    thresh = params.epsilon * params.epsilon * h * w if use_eps else -1.0
    warps, iterations = int(params.warps), int(params.iterations)
    with torch.cuda.device(dev):
        u1_out = torch.empty_like(u1)
        u2_out = torch.empty_like(u2)
        iters = torch.empty(n, dtype=torch.int32, device=dev)
        scratch = torch.empty(
            lib.tvl1_level_scratch_floats(n, h, w), dtype=torch.float32,
            device=dev,
        )
        err = torch.empty(
            lib.tvl1_blocked_per_chunk_err_floats(n, h, w, warps, iterations,
                                                  k),
            dtype=torch.float32, device=dev,
        )
        cur = torch.empty(2 * n, dtype=torch.int32, device=dev)
        code = lib.tvl1_blocked_level_solve_per_chunk(
            i0.data_ptr(), i1.data_ptr(), u1.data_ptr(), u2.data_ptr(),
            u1_out.data_ptr(), u2_out.data_ptr(), iters.data_ptr(),
            scratch.data_ptr(), err.data_ptr(), cur.data_ptr(),
            n, h, w, warps, iterations, int(k),
            float(params.lambda_ * params.theta), float(params.theta),
            float(params.tau / params.theta), float(thresh),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"tvl1_blocked_level_solve_per_chunk: CUDA error {code}: "
            f"{lib.tvl1_blocked_error_string(code).decode()}"
        )
    return u1_out, u2_out, iters
