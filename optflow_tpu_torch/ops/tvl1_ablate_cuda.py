"""The iteration-ablation kernel on the GPU: wrapper of the hand-written CUDA
kernel (``csrc/tvl1_ablate.cu``) and its plain PyTorch version.

:func:`tvl1_ablate_chunks` runs the chunk kernel's primal-dual iteration a
FIXED ``m`` times per image on precomputed warped arrays
``ro = (i1wx, i1wy, rho_c)`` and a state ``(u1, u2, p11, p12, p21, p22)``,
with up to four classes of cost compiled out of the iteration:

``err``   the sum of squared flow updates and its reduction (off: the
          per-image value returned is 1);
``sqrt``  the two square roots of the dual norms (off: the squared norm);
``div``   the five divisions (off: multiplications by the same operand);
``roll``  the eight reads of a neighbouring pixel (off: the pixel's own
          value, so every difference is 0).

The six variants the tool times are in :data:`VARIANTS`, under the names of
the JAX package's ``tools_kernel_ablate.py``. With all four on, the kernel is
the chunk kernel's tile mode with the exit disabled, bit for bit. ``div=False``
drives the state to inf/NaN within a few iterations; that is the variant's
nature (it exists to be timed), not a fault.

On a CUDA tensor the wrapper launches the kernel or raises; a CPU tensor
takes :func:`tvl1_ablate_plain`. The library is compiled at the first CUDA
call (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from optflow_tpu_torch.ops import _build
from optflow_tpu_torch.ops.tvl1 import _GRAD_EPS
from optflow_tpu_torch.ops.warp import divergence, forward_gradient

# Iterations per launch and the tile, as the chunk kernel's tile mode
# (csrc/tvl1_ablate.cu); the wrapper checks them against the library.
ABLATE_K = 8
TILE_H, TILE_W = 32, 64

# The solver constants the JAX tool fixes (tools_kernel_ablate.py:36):
# lambda * theta, theta, tau / theta at the reference defaults.
L_T, THETA, TAUT = 0.05 * 0.3, 0.3, 0.25 / 0.3

# name -> the four switches; names and order of tools_kernel_ablate.py:210
VARIANTS: Dict[str, Dict[str, bool]] = {
    "full": dict(err=True, sqrt=True, div=True, roll=True),
    "no_err": dict(err=False, sqrt=True, div=True, roll=True),
    "no_sqrt": dict(err=True, sqrt=False, div=True, roll=True),
    "no_div": dict(err=True, sqrt=True, div=False, roll=True),
    "no_roll": dict(err=True, sqrt=True, div=True, roll=False),
    "min_body": dict(err=False, sqrt=False, div=False, roll=False),
}

_lib: Optional[ctypes.CDLL] = None


def launches_per_call(m: int) -> int:
    """Device launches of the tile kernel that one call with ``m`` iterations
    makes (one more sums the errors)."""
    return -(-m // ABLATE_K)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("tvl1_ablate")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tvl1_ablate.argtypes = [ptr] * 6 + [i32] * 8 + [f32] * 3 + [ptr]
        lib.tvl1_ablate.restype = i32
        lib.tvl1_ablate_error_string.argtypes = [i32]
        lib.tvl1_ablate_error_string.restype = ctypes.c_char_p
        built = (lib.tvl1_ablate_k(), lib.tvl1_ablate_tile_h(),
                 lib.tvl1_ablate_tile_w())
        if built != (ABLATE_K, TILE_H, TILE_W):
            raise RuntimeError(
                f"csrc/tvl1_ablate.cu was built with (k, tile) {built}, the "
                f"wrapper expects {(ABLATE_K, TILE_H, TILE_W)}"
            )
        _lib = lib
    return _lib


def _check_inputs(ro, state, m, h, w, flags) -> None:
    if state.dim() != 4 or state.shape[1] != 6:
        raise ValueError(f"state must be (N, 6, HP, WP), got {tuple(state.shape)}")
    n, _, hp, wp = state.shape
    if tuple(ro.shape) != (n, 3, hp, wp):
        raise ValueError(f"ro must be {(n, 3, hp, wp)}, got {tuple(ro.shape)}")
    for name, t in (("ro", ro), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ro.device != state.device:
        raise ValueError(f"tensors on {ro.device} and {state.device}")
    if not (2 <= h <= hp and 2 <= w <= wp) or not 1 <= n <= 65535:
        raise ValueError(
            f"real size {h} x {w} does not fit the arrays {tuple(state.shape)}"
        )
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    if flags not in VARIANTS.values():
        raise ValueError(
            f"{flags} is none of the variants {', '.join(VARIANTS)}"
        )


def _ablate_iteration(u1, u2, p11, p12, p21, p22, i1wx, i1wy, rho_c,
                      err, sqrt, div, roll):
    """One iteration of ``ops/tvl1.py``'s ``_iteration`` (gamma 0) on
    ``(N, H, W)`` arrays with the switched-off cost classes removed. Returns
    the six new arrays and the ``(N,)`` error sum (ones with ``err`` off)."""
    grad = i1wx * i1wx + i1wy * i1wy
    rho = rho_c + i1wx * u1 + i1wy * u2
    lo = rho < -L_T * grad
    hi = rho > L_T * grad
    guard = torch.clamp(grad, min=_GRAD_EPS)
    fi = -rho / guard if div else -rho * guard
    mid_ok = grad > _GRAD_EPS
    zero = torch.zeros_like(rho)

    def step(coef):
        return torch.where(
            lo, L_T * coef,
            torch.where(hi, -L_T * coef, torch.where(mid_ok, fi * coef, zero)),
        )

    def div_p(a, b):
        if roll:
            return divergence(a, b)
        # a neighbour reads as the pixel itself: the differences vanish and
        # only the first row/column, which takes p itself, is left
        d = torch.zeros_like(a)
        d[..., :, 0] += a[..., :, 0]
        d[..., 0, :] += b[..., 0, :]
        return d

    u1n = (u1 + step(i1wx)) + THETA * div_p(p11, p12)
    u2n = (u2 + step(i1wy)) + THETA * div_p(p21, p22)
    if err:
        e = ((u1n - u1) ** 2 + (u2n - u2) ** 2).sum(dim=(-2, -1))
    else:
        e = torch.ones(u1.shape[0], dtype=u1.dtype, device=u1.device)
    if roll:
        u1x, u1y = forward_gradient(u1n)
        u2x, u2y = forward_gradient(u2n)
    else:
        u1x = u1y = u2x = u2y = zero
    s1 = u1x * u1x + u1y * u1y
    s2 = u2x * u2x + u2y * u2y
    ng1 = 1.0 + TAUT * (torch.sqrt(s1) if sqrt else s1)
    ng2 = 1.0 + TAUT * (torch.sqrt(s2) if sqrt else s2)
    if div:
        p11, p12 = (p11 + TAUT * u1x) / ng1, (p12 + TAUT * u1y) / ng1
        p21, p22 = (p21 + TAUT * u2x) / ng2, (p22 + TAUT * u2y) / ng2
    else:
        p11, p12 = (p11 + TAUT * u1x) * ng1, (p12 + TAUT * u1y) * ng1
        p21, p22 = (p21 + TAUT * u2x) * ng2, (p22 + TAUT * u2y) * ng2
    return (u1n, u2n, p11, p12, p21, p22), e


def tvl1_ablate_plain(
    ro: torch.Tensor,  # (N, 3, HP, WP) float32: i1wx, i1wy, rho_c
    state: torch.Tensor,  # (N, 6, HP, WP) float32
    m: int,
    h: int,
    w: int,
    *,
    err: bool = True,
    sqrt: bool = True,
    div: bool = True,
    roll: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`tvl1_ablate_chunks`: same arguments,
    same result, on whatever device the tensors lie."""
    flags = dict(err=err, sqrt=sqrt, div=div, roll=roll)
    _check_inputs(ro, state, m, h, w, flags)
    with torch.no_grad():
        i1wx, i1wy, rho_c = ro[:, :, :h, :w].unbind(1)
        planes = state[:, :, :h, :w].unbind(1)
        e = None
        for _ in range(m):
            planes, e = _ablate_iteration(*planes, i1wx, i1wy, rho_c, **flags)
        out = state.clone()
        out[:, :, :h, :w] = torch.stack(planes, dim=1)
        return out, e[:, None]


def tvl1_ablate_chunks(
    ro: torch.Tensor,  # (N, 3, HP, WP) float32: i1wx, i1wy, rho_c
    state: torch.Tensor,  # (N, 6, HP, WP) float32
    m: int,
    h: int,
    w: int,
    *,
    err: bool = True,
    sqrt: bool = True,
    div: bool = True,
    roll: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``m`` iterations of every image, never fewer, with the switched-off
    cost classes compiled out. Returns ``(new_state, errs)``: the state in the
    shape it came in, and ``errs`` ``(N, 1)``, each image's sum of
    ``|u_new - u|^2`` over the real ``h x w`` at the last iteration (ones
    with ``err`` off).

    ``h x w`` is the real size inside the ``HP x WP`` arrays (the JAX tool's
    padded canvases); the iteration's borders are the real ones, and what
    lies outside is returned unchanged (the TPU kernel updates it with values
    nothing reads).

    CUDA tensors launch the kernel on the current stream without
    synchronising (``tvl1_ablate_chunks.launches`` counts these calls;
    :func:`launches_per_call` device launches each) or raise; CPU tensors
    take the plain version."""
    if not state.is_cuda:
        return tvl1_ablate_plain(ro, state, m, h, w, err=err, sqrt=sqrt,
                                 div=div, roll=roll)
    flags = dict(err=err, sqrt=sqrt, div=div, roll=roll)
    _check_inputs(ro, state, m, h, w, flags)
    lib = _library()
    n, _, hp, wp = state.shape
    padded = (hp, wp) != (h, w)
    dev = state.device
    with torch.cuda.device(dev):
        src_ro = ro[:, :, :h, :w].contiguous() if padded else ro
        src = state[:, :, :h, :w].contiguous() if padded else state
        out = torch.empty_like(src)
        scratch = torch.empty_like(src) if m > ABLATE_K else None
        tiles = -(-h // TILE_H) * -(-w // TILE_W)
        tile_errs = torch.empty((n, tiles), dtype=torch.float32, device=dev)
        errs = torch.empty((n, 1), dtype=torch.float32, device=dev)
        code = lib.tvl1_ablate(
            src_ro.data_ptr(), src.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            tile_errs.data_ptr(), errs.data_ptr(), n, h, w, int(m),
            int(err), int(sqrt), int(div), int(roll),
            float(L_T), float(THETA), float(TAUT),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"tvl1_ablate: CUDA error {code}: "
            f"{lib.tvl1_ablate_error_string(code).decode()}"
        )
    tvl1_ablate_chunks.launches += 1
    if padded:
        full = state.clone()
        full[:, :, :h, :w] = out
        out = full
    return out, errs


tvl1_ablate_chunks.launches = 0
