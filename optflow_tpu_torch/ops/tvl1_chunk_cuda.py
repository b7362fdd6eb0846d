"""The TV-L1 chunk kernel on the GPU and the per-level solve built on it:
wrapper of the hand-written CUDA kernel (``csrc/tvl1_chunk.cu``), its plain
PyTorch version, and the level solve behind ``tvl1_flow(level_solver=...)``.

:func:`tvl1_chunk` runs up to ``m`` primal-dual iterations on precomputed
warped arrays ``ro = (i1wx, i1wy, rho_c)`` and a state
``(u1, u2, p11, p12, p21, p22)``; it returns the new state and, per image and
block, the sum of squared flow updates of the last iteration run. A level
whose nine arrays fit one thread block's shared memory runs in one block per
image with the exact per-iteration epsilon exit inside the kernel; a larger
level runs in 32 x 64 tiles, at most :data:`CHUNK_K` iterations per launch.
On a CUDA tensor the wrapper launches the kernel or raises; a CPU tensor
takes :func:`tvl1_chunk_plain`.

:func:`tvl1_chunk_level_solve` solves one whole pyramid level with the
chunk kernel's exit rule (after every :data:`CHUNK_K`-th iteration of a
sweep in tile mode, after every iteration in one-block mode): on the card
ONE call into the library, one cooperative launch of the persistent level
grid (``csrc/tvl1_grid.cuh``) that computes the gradient, every sweep's
exact warp and the sweeps; a CPU tensor takes
:func:`tvl1_chunk_level_solve_plain`. :func:`tvl1_flow_level_cuda_batched`,
the per-level API's solver, calls it once a level; nothing is read back.

:func:`tvl1_chunk_sweep` is the path it replaces, kept until ``ROADMAP.md``
deletes it: one sweep on a warp computed outside, every chunk enqueued by one
call into the library, each launch deciding on the device which images it
still runs. No path of the package selects it.

The library is compiled at the first CUDA call (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops import _build
from optflow_tpu_torch.ops.tvl1 import _iteration, _LevelState, level_solve_plain
from optflow_tpu_torch.ops.tvl1_cuda import _check_inputs as _check_level
from optflow_tpu_torch.ops.tvl1_cuda import bind_grid, launch_grid

# Halo width = most iterations per launch in tile mode: the JAX package's
# _DEFAULT_K (optflow_tpu/ops/tvl1_pallas.py:100). The tile is the kernel's
# (csrc/tvl1_chunk.cu); the wrapper checks both against the library.
CHUNK_K = 8
TILE_H, TILE_W = 32, 64
# One-block mode: 9 float planes of the level in one block's shared memory
# (227 KB = 232,448 B on sm_90, less the reduction's scratch).
ONE_BLOCK_MAX_PX = (232448 - 256) // 36

_lib: Optional[ctypes.CDLL] = None


class ChunkGeometry(NamedTuple):
    one_block: bool
    tiles_y: int
    tiles_x: int

    @property
    def blocks(self) -> int:
        return self.tiles_y * self.tiles_x


def chunk_geometry(h: int, w: int) -> ChunkGeometry:
    """How a level of ``h x w`` is cut: one block, or 32 x 64 tiles."""
    if h * w <= ONE_BLOCK_MAX_PX:
        return ChunkGeometry(True, 1, 1)
    return ChunkGeometry(False, -(-h // TILE_H), -(-w // TILE_W))


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("tvl1_chunk")
        bind_grid(lib, "tvl1_chunk_level_solve", extra_ints=1)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tvl1_chunk.argtypes = [ptr] * 6 + [i32] * 5 + [f32] * 4 + [ptr]
        lib.tvl1_chunk.restype = i32
        lib.tvl1_chunk_sweep.argtypes = (
            [ptr] * 6 + [i32] * 5 + [f32] * 4 + [ptr]
        )
        lib.tvl1_chunk_sweep.restype = i32
        lib.tvl1_chunk_error_string.argtypes = [i32]
        lib.tvl1_chunk_error_string.restype = ctypes.c_char_p
        built = (lib.tvl1_chunk_k(), lib.tvl1_chunk_tile_h(),
                 lib.tvl1_chunk_tile_w())
        if built != (CHUNK_K, TILE_H, TILE_W):
            raise RuntimeError(
                f"csrc/tvl1_chunk.cu was built with (k, tile) {built}, the "
                f"wrapper expects {(CHUNK_K, TILE_H, TILE_W)}"
            )
        _lib = lib
    return _lib


def _check_inputs(ro, state, m, active, iters) -> None:
    if state.dim() != 4 or state.shape[1] != 6:
        raise ValueError(f"state must be (N, 6, H, W), got {tuple(state.shape)}")
    n, _, h, w = state.shape
    if tuple(ro.shape) != (n, 3, h, w):
        raise ValueError(
            f"ro must be {(n, 3, h, w)}, got {tuple(ro.shape)}"
        )
    for name, t in (("ro", ro), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("active", active), ("iters", iters)):
        if t is None:
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise TypeError(f"{name} must be int32 of shape ({n},)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for t in (ro, active, iters):
        if t is not None and t.device != state.device:
            raise ValueError(f"tensors on {t.device} and {state.device}")
    if n < 1 or n > 65535 or h < 2 or w < 2:
        raise ValueError(f"unsupported level shape {tuple(state.shape)}")
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    if not chunk_geometry(h, w).one_block and m > CHUNK_K:
        raise ValueError(
            f"a {h} x {w} level runs in tiles with a halo of {CHUNK_K}: "
            f"m = {m} iterations per call would reach past it"
        )


def _tile_sums(x: torch.Tensor, geo: ChunkGeometry) -> torch.Tensor:
    """``(N, H, W)`` -> ``(N, blocks)`` sums over the kernel's tiles."""
    n, h, w = x.shape
    if geo.one_block:
        return x.sum(dim=(1, 2))[:, None]
    x = torch.nn.functional.pad(
        x, (0, geo.tiles_x * TILE_W - w, 0, geo.tiles_y * TILE_H - h)
    )
    x = x.reshape(n, geo.tiles_y, TILE_H, geo.tiles_x, TILE_W)
    return x.sum(dim=(2, 4)).reshape(n, geo.blocks)


def tvl1_chunk_plain(
    ro: torch.Tensor,  # (N, 3, H, W) float32: i1wx, i1wy, rho_c
    state: torch.Tensor,  # (N, 6, H, W) float32: u1, u2, p11, p12, p21, p22
    m: int,
    thresh: float,
    params: TVL1Params,
    active: Optional[torch.Tensor] = None,  # (N,) int32
    iters: Optional[torch.Tensor] = None,  # (N,) int32, added to in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`tvl1_chunk`: same arguments, same
    result, on whatever device the tensors lie, from the plain solver's
    ``_iteration`` on whole images."""
    _check_inputs(ro, state, m, active, iters)
    n, _, h, w = state.shape
    geo = chunk_geometry(h, w)
    l_t = params.lambda_ * params.theta
    taut = params.tau / params.theta
    with torch.no_grad():
        i1wx, i1wy, rho_c = ro.unbind(1)
        grad = i1wx * i1wx + i1wy * i1wy
        zeros = torch.zeros_like(i1wx)
        u1, u2, p11, p12, p21, p22 = state.unbind(1)
        st = _LevelState(u1, u2, zeros, p11, p12, p21, p22, zeros, zeros)
        on = (torch.ones(n, dtype=torch.bool, device=state.device)
              if active is None else active != 0)
        ran = torch.zeros(n, dtype=torch.int32, device=state.device)
        du2 = torch.zeros_like(i1wx)  # |u_new - u|^2 of the last iteration run
        for _ in range(m):
            new, err = _iteration(
                st, i1wx, i1wy, grad, rho_c, l_t, params.theta, taut, 0.0
            )
            keep = on[:, None, None]
            du2 = torch.where(
                keep, (new.u1 - st.u1) ** 2 + (new.u2 - st.u2) ** 2, du2
            )
            st = _LevelState(*(torch.where(keep, a, b) for a, b in zip(new, st)))
            ran += on.to(torch.int32)
            if geo.one_block:
                on = on & (err > thresh)
                if not bool(on.any()):
                    break
        if iters is not None:
            iters += ran
        new_state = torch.stack(
            [st.u1, st.u2, st.p11, st.p12, st.p21, st.p22], dim=1
        )
        return new_state, _tile_sums(du2, geo)


def tvl1_chunk(
    ro: torch.Tensor,  # (N, 3, H, W) float32: i1wx, i1wy, rho_c
    state: torch.Tensor,  # (N, 6, H, W) float32: u1, u2, p11, p12, p21, p22
    m: int,
    thresh: float,
    params: TVL1Params,
    active: Optional[torch.Tensor] = None,  # (N,) int32
    iters: Optional[torch.Tensor] = None,  # (N,) int32, added to in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``m`` primal-dual iterations of every image on fixed warped
    arrays. Returns ``(new_state, errs)``; ``errs`` is ``(N, blocks)``, each
    block's sum of ``|u_new - u|^2`` over its pixels at the last iteration
    the image ran (``chunk_geometry(h, w).blocks`` blocks; their sum is the
    quantity the epsilon criterion tests).

    One-block levels stop an image inside the kernel once its error is
    ``<= thresh`` (``thresh < 0``: never). Tile-mode levels run exactly
    ``m <= CHUNK_K`` iterations and do not read ``thresh``. An image whose
    ``active`` entry is 0 is passed through unchanged with errors 0. The
    iterations each image ran are added to ``iters`` where given.

    CUDA tensors launch the kernel on the current stream without
    synchronising (``tvl1_chunk.launches`` counts these calls) or raise; CPU
    tensors take the plain version."""
    if not state.is_cuda:
        return tvl1_chunk_plain(ro, state, m, thresh, params, active, iters)
    _check_inputs(ro, state, m, active, iters)
    lib = _library()
    n, _, h, w = state.shape
    geo = chunk_geometry(h, w)
    dev = state.device
    with torch.cuda.device(dev):
        out = torch.empty_like(state)
        errs = torch.empty((n, geo.blocks), dtype=torch.float32, device=dev)
        code = lib.tvl1_chunk(
            ro.data_ptr(), state.data_ptr(), out.data_ptr(), errs.data_ptr(),
            None if active is None else active.data_ptr(),
            None if iters is None else iters.data_ptr(),
            n, h, w, int(m), int(geo.one_block),
            float(params.lambda_ * params.theta), float(params.theta),
            float(params.tau / params.theta), float(thresh),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"tvl1_chunk: CUDA error {code}: "
            f"{lib.tvl1_chunk_error_string(code).decode()}"
        )
    tvl1_chunk.launches += 1
    return out, errs


tvl1_chunk.launches = 0


def _check_sweep(iterations: int) -> None:
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")


def tvl1_chunk_sweep_plain(
    ro: torch.Tensor,  # (N, 3, H, W) float32: i1wx, i1wy, rho_c
    state: torch.Tensor,  # (N, 6, H, W) float32
    iterations: int,
    thresh: float,
    params: TVL1Params,
    iters: Optional[torch.Tensor] = None,  # (N,) int32, added to in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`tvl1_chunk_sweep`: the loop over
    :func:`tvl1_chunk_plain`, one call per chunk of ``CHUNK_K`` iterations,
    an image's later chunks stopped from the errors the last one returned."""
    _check_sweep(iterations)
    _check_inputs(ro, state, 1, None, iters)
    if chunk_geometry(*state.shape[-2:]).one_block:
        return tvl1_chunk_plain(ro, state, iterations, thresh, params,
                                iters=iters)
    active = None
    errs = None
    for done in range(0, iterations, CHUNK_K):
        m = min(CHUNK_K, iterations - done)
        state, errs = tvl1_chunk_plain(
            ro, state, m, thresh, params, active=active, iters=iters
        )
        if thresh >= 0:
            # a stopped image returns 0, so the stop is sticky
            active = (errs.sum(dim=1) > thresh).to(torch.int32)
    return state, errs


def tvl1_chunk_sweep(
    ro: torch.Tensor,  # (N, 3, H, W) float32: i1wx, i1wy, rho_c
    state: torch.Tensor,  # (N, 6, H, W) float32
    iterations: int,
    thresh: float,
    params: TVL1Params,
    iters: Optional[torch.Tensor] = None,  # (N,) int32, added to in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One whole sweep of a level on fixed warped arrays: up to
    ``iterations >= 1`` primal-dual iterations of every image with the level
    solve's exit rule. A one-block level stops each image inside the kernel,
    per iteration; a tile-mode level runs chunks of ``CHUNK_K`` and stops an
    image after the first chunk whose last error is ``<= thresh``
    (``thresh < 0``: never). Returns ``(new_state, errs)``; ``errs`` is
    ``(N, blocks)``, the errors of the last chunk, 0 for an image that had
    stopped before it.

    On CUDA tensors all the chunks are enqueued by one call into the
    library, each launch deciding on the device, from the tile sums of the
    launch before it, which images it runs: no PyTorch operation and nothing
    read back inside the sweep (``tvl1_chunk_sweep.launches`` counts these
    calls). The sums are added on the device in another order than the plain
    version's ``errs.sum(dim=1)``, so an image within rounding of its
    threshold may stop one chunk apart. A failure raises; CPU tensors take
    the plain version."""
    if not state.is_cuda:
        return tvl1_chunk_sweep_plain(ro, state, iterations, thresh, params,
                                      iters)
    _check_sweep(iterations)
    _check_inputs(ro, state, 1, None, iters)
    lib = _library()
    n, _, h, w = state.shape
    geo = chunk_geometry(h, w)
    dev = state.device
    launches = 1 if geo.one_block else -(-int(iterations) // CHUNK_K)
    with torch.cuda.device(dev):
        out = torch.empty_like(state)
        scratch = torch.empty_like(state) if launches > 1 else None
        errs = torch.empty((2, n, geo.blocks), dtype=torch.float32, device=dev)
        code = lib.tvl1_chunk_sweep(
            ro.data_ptr(), state.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), errs.data_ptr(),
            None if iters is None else iters.data_ptr(),
            n, h, w, int(iterations), int(geo.one_block),
            float(params.lambda_ * params.theta), float(params.theta),
            float(params.tau / params.theta), float(thresh),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"tvl1_chunk_sweep: CUDA error {code}: "
            f"{lib.tvl1_chunk_error_string(code).decode()}"
        )
    tvl1_chunk_sweep.launches += 1
    return out, errs[(launches - 1) & 1]


tvl1_chunk_sweep.launches = 0


def level_exit_every(h: int, w: int) -> int:
    """The chunk kernel's exit period at an ``h x w`` level: every
    iteration in one-block mode, every :data:`CHUNK_K` in tiles."""
    return 1 if chunk_geometry(h, w).one_block else CHUNK_K


def tvl1_chunk_level_solve_plain(
    i0: torch.Tensor,  # (N, H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`tvl1_chunk_level_solve`: the plain
    level solve with the exit tested every ``level_exit_every(h, w)``
    iterations, on whatever device the tensors lie."""
    _check_level(i0, i1, u1, u2, params)
    a, b, _, iters = level_solve_plain(
        i0, i1, u1, u2, params, exit_every=level_exit_every(*i0.shape[-2:]))
    return a, b, iters


def tvl1_chunk_level_solve(
    i0: torch.Tensor,  # (N, H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve one pyramid level for a batch with the chunk kernel's exit
    rule: the dual state zero at level entry and kept across the ``warps``
    sweeps, each one exact warp and up to ``iterations`` updates; with
    ``epsilon > 0`` a tile-mode level tests an image after every
    :data:`CHUNK_K`-th iteration of a sweep, on that iteration's sum of
    squared updates, a one-block level after every iteration. Returns
    ``(u1, u2, iters)``.

    CUDA tensors: one call into the library, one kernel launch and its
    memsets, nothing of PyTorch but the outputs' allocation
    (``tvl1_chunk_level_solve.launches`` counts the calls; ``last_work`` and
    ``last_steps`` as ``tvl1_level_solve``'s); a failure raises. The tile
    sums are added in tile order, not in the plain version's, so an image
    within rounding of its threshold may stop a test apart. CPU tensors take
    the plain version."""
    if not i0.is_cuda:
        return tvl1_chunk_level_solve_plain(i0, i1, u1, u2, params)
    h, w = i0.shape[-2:]
    u1_out, u2_out, iters, work, steps = launch_grid(
        _library(), "tvl1_chunk_level_solve", i0, i1, u1, u2, params,
        level_exit_every(h, w), int(chunk_geometry(h, w).one_block),
    )
    tvl1_chunk_level_solve.launches += 1
    tvl1_chunk_level_solve.last_work = work
    tvl1_chunk_level_solve.last_steps = steps
    return u1_out, u2_out, iters


tvl1_chunk_level_solve.launches = 0
tvl1_chunk_level_solve.last_work = None
tvl1_chunk_level_solve.last_steps = None


def tvl1_flow_level_cuda_batched(
    i0: torch.Tensor,  # (N, H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
    u3: Optional[torch.Tensor] = None,
    return_iters: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Per-level TV-L1 solve of a batch with the chunk kernel's exit rule,
    one :func:`tvl1_chunk_level_solve` call. Returns ``(u1, u2, u3)``, and
    the iterations each image ran as a fourth value with ``return_iters``.
    ``gamma != 0`` is not solved by the kernel and goes to the plain
    solver."""
    if params.gamma != 0.0:
        out = level_solve_plain(i0, i1, u1, u2, params, u3=u3)
        return out if return_iters else out[:3]
    a, b, iters = tvl1_chunk_level_solve(i0, i1, u1, u2, params)
    if u3 is None:
        u3 = torch.zeros_like(u1)
    if return_iters:
        return a, b, u3, iters
    return a, b, u3


def tvl1_flow_level_cuda(
    i0: torch.Tensor,  # (H, W) float32
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
    u3: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-image form of :func:`tvl1_flow_level_cuda_batched`, with the
    signature of ``ops.tvl1.tvl1_flow_level``."""
    a, b, c = tvl1_flow_level_cuda_batched(
        i0[None], i1[None], u1[None], u2[None], params,
        u3=None if u3 is None else u3[None],
    )
    return a[0], b[0], c[0]
