"""The TV-L1 level solve on the GPU: wrapper of the hand-written CUDA kernel
(``csrc/tvl1_level.cu``), its plain PyTorch version, and the coarse-to-fine
solve that runs it at every pyramid level, whatever the level's size
(:func:`tvl1_flow_batched_cuda`: every style-1 path, the distributed ones and
style 2). Every level so stops on the exact per-iteration exit of the plain
solver.

:func:`tvl1_level_solve` solves one whole level for a batch: given
``(i0, i1, u1, u2)`` it returns ``(u1, u2, iterations run per image)``. On a
CUDA tensor it launches the kernel or raises; a CPU tensor takes
:func:`tvl1_level_solve_plain`, which computes the same function from the
plain solver's ``_iteration`` and ``warp_backward``. ``gamma != 0`` is not
solved by the kernel (``ops.tvl1.tvl1_flow_batched`` routes it to the plain
solver).

The kernel runs a sweep's iterations in chunks on tiles held in shared
memory (:data:`LEVEL_SCHEDULE` iterations per chunk) and keeps the exact
per-iteration exit by running a chunk speculatively and, where an image's
exit fell inside it, once more from the chunk's input up to the exit. The
same persistent grid (``csrc/tvl1_grid.cuh``) serves the blocked kernel
(``ops/tvl1_blocked_cuda.py``, the counterpart of the JAX package's blocked
level kernel, which no path of this package selects) and the chunk kernel
with an exit every ``E`` iterations (:func:`launch_grid`);
:func:`tvl1_level_solve_schedule_plain` is the grid's control flow on whole
images in plain PyTorch, for any exit period: it must equal
``level_solve_plain(exit_every=E)`` bit for bit, flow and counts.

The library is compiled at the first CUDA call (``ops/_build.py``), so
importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops import _build
from optflow_tpu_torch.ops.tvl1 import (
    _iteration,
    _LevelState,
    level_solve_plain,
    solve_pyramid,
)
from optflow_tpu_torch.ops.warp import centered_gradient, warp_backward

# Iterations per chunk with the exact exit, in order within a sweep; the last
# entry repeats. A constant of the grid (csrc/tvl1_grid.cuh), mirrored here
# for the plain emulation; the wrappers check it against each library.
LEVEL_SCHEDULE = (2, 2, 4)
# The kernel's tiles: at most 32 rows (a level is cut into rows of tiles of
# equal height) by 64 columns, loaded with a halo of 4 pixels on every side.
LEVEL_TILE_H, LEVEL_TILE_W, LEVEL_HALO = 32, 64, 4

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    with _build.lock:
        if _lib is None:
            lib = _build.load_library("tvl1_level")
            bind_grid(lib, "tvl1_level_solve", extra_ints=0)
            _lib = lib
    return _lib


def bind_grid(lib: ctypes.CDLL, entry: str, extra_ints: int) -> None:
    """Declare the argument types of a library that includes
    ``csrc/tvl1_grid.cuh``: its level entry ``entry`` (eleven pointers, five
    ints and ``extra_ints`` more, four floats, the stream) and the header's
    sizing functions; check the header's constants against this module's."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # pointers and the stream are Python ints: without argtypes ctypes would
    # pass them as 32-bit ints and cut them
    fn = getattr(lib, entry)
    fn.argtypes = [ptr] * 11 + [i32] * (5 + extra_ints) + [f32] * 4 + [ptr]
    fn.restype = i32
    for fn in (lib.tvl1_level_scratch_floats, lib.tvl1_level_err_floats):
        fn.argtypes = [i32, i32, i32]
        fn.restype = ctypes.c_longlong
    lib.tvl1_level_table_ints.argtypes = [i32] * 4
    lib.tvl1_level_table_ints.restype = ctypes.c_longlong
    lib.tvl1_level_schedule.argtypes = [i32]
    lib.tvl1_error_string.argtypes = [i32]
    lib.tvl1_error_string.restype = ctypes.c_char_p
    built = (tuple(lib.tvl1_level_schedule(c)
                   for c in range(lib.tvl1_level_schedule_len())),
             lib.tvl1_level_tile_h(), lib.tvl1_level_tile_w(),
             lib.tvl1_level_halo())
    expected = (LEVEL_SCHEDULE, LEVEL_TILE_H, LEVEL_TILE_W, LEVEL_HALO)
    if built != expected:
        raise RuntimeError(
            f"csrc/tvl1_grid.cuh was built with (schedule, tile, halo) "
            f"{built}, the wrapper expects {expected}"
        )


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


def level_chunk_schedule(iterations: int, exit_every: int = 1) -> List[int]:
    """Iterations of each chunk of one sweep of ``iterations``. With the
    exact exit (``exit_every = 1``) the entries of :data:`LEVEL_SCHEDULE`,
    the last one repeated; with an exit every ``E > 1`` iterations chunks of
    at most the halo, each cut at the next multiple of ``E``, so that every
    test falls on a chunk's last iteration. The final chunk is cut so that
    they add up."""
    chunks, done = [], 0
    while done < iterations:
        if exit_every == 1:
            m = LEVEL_SCHEDULE[min(len(chunks), len(LEVEL_SCHEDULE) - 1)]
        else:
            m = min(LEVEL_HALO, exit_every - done % exit_every)
        chunks.append(min(m, iterations - done))
        done += chunks[-1]
    return chunks


def level_tiles(h: int, w: int) -> int:
    """Tiles of one ``h x w`` image: the items one image adds to a step."""
    return -(-h // LEVEL_TILE_H) * -(-w // LEVEL_TILE_W)


def level_window_px(h: int) -> int:
    """Pixels of the window one tile of an ``h``-row level loads for a chunk:
    the tile (a level is cut into rows of tiles of equal height) and its
    halo."""
    tile_rows = -(-h // LEVEL_TILE_H)
    tile_h = -(-h // tile_rows)
    return (tile_h + 2 * LEVEL_HALO) * (LEVEL_TILE_W + 2 * LEVEL_HALO)


def level_max_steps(warps: int, iterations: int, exit_every: int = 1) -> int:
    """Grid-wide steps one level solve takes at most: per sweep its chunks
    and, with the exact exit, one step that settles the last chunk's exit.
    The kernel leaves a sweep as soon as no image has anything left to do;
    the steps it did take are in ``last_steps[0]`` of its wrapper."""
    if iterations <= 0:
        return 0
    chunks = len(level_chunk_schedule(iterations, exit_every))
    return int(warps) * (chunks + (exit_every == 1))


def tvl1_level_solve_schedule_plain(
    i0: torch.Tensor,  # (N, H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
    exit_every: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grid's control flow on whole images, in plain PyTorch: chunks of
    :func:`level_chunk_schedule`. With the exact exit (``exit_every = 1``)
    they run speculatively with every iteration's error kept; the step after
    a chunk finds each image's first iteration whose error met the criterion
    and, where that was not the chunk's last, runs the chunk again from its
    kept input up to it. With ``exit_every = E > 1`` the step after a chunk
    that ends on a multiple of ``E`` (not the sweep's last) tests its last
    iteration's error, and nothing is replayed. Returns
    ``(u1, u2, iters, computed)``: the first three equal
    ``level_solve_plain(exit_every=E)`` bit for bit; ``computed`` is the
    iterations run for each image, those past an exit and the replays
    included."""
    _check_inputs(i0, i1, u1, u2, params)
    l_t = params.lambda_ * params.theta
    taut = params.tau / params.theta
    n, h, w = i0.shape
    use_eps = params.epsilon > 0
    thresh = params.epsilon * params.epsilon * h * w
    dev = i0.device

    def masked(mask, new, old):
        keep = mask[:, None, None]
        return _LevelState(*(torch.where(keep, a, b) for a, b in zip(new, old)))

    with torch.no_grad():
        i1x, i1y = centered_gradient(i1)
        zeros = torch.zeros_like(i0)
        state = _LevelState(u1, u2, zeros, *([zeros] * 6))
        iters = torch.zeros(n, dtype=torch.int32, device=dev)
        computed = torch.zeros_like(iters)
        for _ in range(params.warps):
            _, i1wx, i1wy, grad, rho_c = warp_backward(
                i0, i1, i1x, i1y, state.u1, state.u2
            )

            def run(start, m, who):
                """``m`` iterations from ``start`` for the images of ``who``:
                (end state, errors (m, N))."""
                st, errs = start, []
                for _ in range(m):
                    st, err = _iteration(
                        st, i1wx, i1wy, grad, rho_c, l_t, params.theta, taut,
                        0.0,
                    )
                    errs.append(err)
                return masked(who, st, start), errs

            running = torch.ones(n, dtype=torch.bool, device=dev)
            kept, errs, m_prev, done = state, [], 0, 0
            # the schedule's chunks, then one step that only settles
            chunks = level_chunk_schedule(params.iterations, exit_every)
            for m in chunks + [0]:
                if m_prev and use_eps and exit_every > 1:
                    if done % exit_every == 0 and done < params.iterations:
                        # NaN stops too
                        running = running & (errs[-1] > thresh)
                elif m_prev and use_eps:
                    met = torch.stack(errs) <= thresh  # (m_prev, N)
                    met |= torch.stack(errs).isnan()
                    first = torch.where(
                        met.any(0), met.int().argmax(0), m_prev
                    )  # m_prev: no exit in the chunk
                    stops = running & (first < m_prev)
                    replays = stops & (first < m_prev - 1)
                    for j in sorted(set(first[replays].tolist())):
                        who = replays & (first == j)
                        again, _ = run(kept, j + 1, who)
                        state = masked(who, again, state)
                        iters += who.int() * (j + 1 - m_prev)
                        computed += who.int() * (j + 1)
                    running = running & ~stops
                if m == 0 or not bool(running.any()):
                    break
                kept = state
                state, errs = run(state, m, running)
                iters += running.int() * m
                computed += running.int() * m
                m_prev = m
                done += m
    return state.u1, state.u2, iters, computed


def launch_grid(lib: ctypes.CDLL, entry: str, i0, i1, u1, u2,
                params: TVL1Params, exit_every: int, *extra: int):
    """Enqueue one level solve on CUDA tensors through ``entry`` of a library
    that runs the persistent grid (``csrc/tvl1_grid.cuh``) with an exit
    every ``exit_every`` iterations; ``extra`` are the entry's own ints after
    the iteration count. Returns ``(u1, u2, iters, work, steps)``: ``work``
    is ``(2, N)`` int32, per image the iterations computed (chunks run past
    an exit and replays included) and the chunks that ran; ``steps`` is
    int32: the grid-wide steps the call took, the blocks of its grid, and
    then for every step the images that ran in it (a 0 ends each sweep).
    Raises on a CUDA error, a refused launch included."""
    _check_inputs(i0, i1, u1, u2, params)
    n, h, w = i0.shape
    dev = i0.device
    use_eps = params.epsilon > 0
    thresh = params.epsilon * params.epsilon * h * w if use_eps else -1.0
    warps, iterations = int(params.warps), int(params.iterations)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        u1_out = torch.empty_like(u1)
        u2_out = torch.empty_like(u2)
        # iterations run; then what was computed for them: iterations,
        # chunks
        counts = torch.empty((3, n), dtype=torch.int32, device=dev)
        scratch = torch.empty(
            lib.tvl1_level_scratch_floats(n, h, w), dtype=torch.float32,
            device=dev,
        )
        err = torch.empty(
            lib.tvl1_level_err_floats(n, h, w), dtype=torch.float32,
            device=dev,
        )
        tables = torch.empty(
            lib.tvl1_level_table_ints(n, warps, iterations, exit_every),
            dtype=torch.int32, device=dev,
        )
        code = getattr(lib, entry)(
            i0.data_ptr(), i1.data_ptr(), u1.data_ptr(), u2.data_ptr(),
            u1_out.data_ptr(), u2_out.data_ptr(), counts[0].data_ptr(),
            counts[1].data_ptr(), scratch.data_ptr(), err.data_ptr(),
            tables.data_ptr(), n, h, w, warps, iterations, *extra,
            float(params.lambda_ * params.theta), float(params.theta),
            float(params.tau / params.theta), float(thresh), stream,
        )
    if code != 0:
        raise RuntimeError(
            f"{entry}: CUDA error {code}: "
            f"{lib.tvl1_error_string(code).decode()}"
        )
    return u1_out, u2_out, counts[0], counts[1:], tables[4 * n:]


@_build.counted_launches
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
    each image stops at the first iteration whose own sum of squared updates
    is ``<= epsilon^2 * H * W``. Returns ``(u1, u2, iters)``: the new flow and
    the iterations each image ran, ``(N,)`` int32, summed over the sweeps.

    CUDA tensors launch the kernel on the current stream without
    synchronising (``tvl1_level_solve.launches`` counts these calls in every
    thread; ``tvl1_level_solve.last_work`` keeps, on the device, what the
    calling thread's last call computed per image, speculation and replays
    included: ``(2, N)`` int32 of iterations and chunks; ``last_steps``,
    int32, the grid-wide steps it took, the blocks of its grid, and per step
    the images that ran in it, a 0 ending each sweep) or raise; CPU tensors
    take the plain version."""
    if not i0.is_cuda:
        return tvl1_level_solve_plain(i0, i1, u1, u2, params)
    u1_out, u2_out, iters, work, steps = launch_grid(
        _library(), "tvl1_level_solve", i0, i1, u1, u2, params, 1
    )
    tvl1_level_solve.count_launch(work, steps)
    return u1_out, u2_out, iters


def _level_solver(i0, i1, u1, u2, params, u3):
    a, b, iters = tvl1_level_solve(i0, i1, u1, u2, params)
    return a, b, u3, iters


def tvl1_flow_batched_cuda(
    i0s: torch.Tensor,  # (N, H, W)
    i1s: torch.Tensor,
    params: TVL1Params = TVL1Params(),
    init_flow: Optional[torch.Tensor] = None,  # (N, H, W, 2)
) -> torch.Tensor:
    """Full coarse-to-fine TV-L1 flow of a batch with :func:`tvl1_level_solve`
    at every pyramid level: the epsilon exit is tested after every iteration
    at every level, the rule of the plain solver
    (``ops.tvl1.level_solve_plain``). Nothing is read back inside the solve;
    the per-level iteration counts are kept on the device
    (``ops.tvl1.get_last_iteration_stats``). CUDA tensors launch the kernel
    at every level or raise (``gamma != 0``, a failed build or launch); CPU
    tensors take its plain version at every level."""
    return solve_pyramid(i0s, i1s, params, init_flow, _level_solver)
