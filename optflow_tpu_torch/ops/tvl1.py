"""Coarse-to-fine TV-L1 dense optical flow — the plain PyTorch solver.

The duality-based TV-L1 scheme (Zach/Pock/Bischof primal-dual with flow
linearization) that the reference invokes through
cv::cuda::OpticalFlowDual_TVL1 (src/optflow.cpp:516-520) with the tuned
defaults of generate_TV_args (src/optflow.cpp:500-514): tau=0.25,
lambda=0.05, theta=0.3, nscales=10, warps=5, epsilon=0.01, iterations=300,
scaleStep=0.8, gamma=0.

Per pyramid level (coarse -> fine):
  p (dual) zeroed once per level; then ``warps`` times:
    - warp (I1, I1x, I1y) backward by current flow, linearize residual rho_c
    - up to ``iterations`` primal-dual updates with early exit when the mean
      squared flow update drops below epsilon^2 (checked per iteration and
      PER IMAGE of a batch, as the reference solver does for its one image)
  then the flow is upsampled to the next finer level and scaled by
  1/scaleStep.

The primal update is the closed-form soft-threshold on the linearized
residual followed by u = v + theta * div(p); the dual update is a
forward-difference gradient ascent projected via p <- (p + taut*grad u)
/ (1 + taut*|grad u|), taut = tau/theta.

When ``gamma > 0`` a third primal variable u3 (illumination offset) with its
own dual pair is solved (grad' = grad + gamma^2; rho includes gamma*u3).

This module is the port's oracle, its CPU path and its gamma != 0 path.
:func:`tvl1_flow_batched` sends CUDA tensors with gamma == 0 to the
hand-written level kernel (ops/tvl1_cuda.py); everything runs eagerly under
``torch.no_grad()`` (the solver has no gradient).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops.pyramid import (
    build_pyramid,
    pyramid_shapes,
    resize_bilinear,
    upscale_flow,
)
from optflow_tpu_torch.ops.warp import (
    centered_gradient,
    divergence,
    forward_gradient,
    warp_backward,
)

_GRAD_EPS = 1.192092896e-07  # FLT_EPSILON guard on the |grad I1w|^2 division


class _LevelState(NamedTuple):
    u1: torch.Tensor
    u2: torch.Tensor
    u3: torch.Tensor
    p11: torch.Tensor
    p12: torch.Tensor
    p21: torch.Tensor
    p22: torch.Tensor
    p31: torch.Tensor
    p32: torch.Tensor


def _iteration(
    state: _LevelState,
    i1wx: torch.Tensor,
    i1wy: torch.Tensor,
    grad: torch.Tensor,
    rho_c: torch.Tensor,
    l_t: float,
    theta: float,
    taut: float,
    gamma: float,
) -> Tuple[_LevelState, torch.Tensor]:
    """One primal-dual update of an ``(N, H, W)`` batch. Returns (new_state,
    per-image sum of squared flow updates ``(N,)``) — the error the epsilon
    stop criterion monitors."""
    u1, u2, u3 = state.u1, state.u2, state.u3
    use_gamma = gamma != 0.0

    rho = rho_c + i1wx * u1 + i1wy * u2
    g = grad
    if use_gamma:
        rho = rho + gamma * u3
        g = grad + gamma * gamma

    # Closed-form primal step on the linearized data term (soft threshold).
    lo = rho < -l_t * g
    hi = rho > l_t * g
    fi = -rho / torch.clamp(g, min=_GRAD_EPS)
    mid_ok = g > _GRAD_EPS
    zero = torch.zeros_like(rho)

    def step(coef):
        return torch.where(
            lo, l_t * coef,
            torch.where(hi, -l_t * coef, torch.where(mid_ok, fi * coef, zero)),
        )

    v1 = u1 + step(i1wx)
    v2 = u2 + step(i1wy)

    u1_new = v1 + theta * divergence(state.p11, state.p12)
    u2_new = v2 + theta * divergence(state.p21, state.p22)

    if use_gamma:
        v3 = u3 + step(torch.full_like(rho, gamma))
        u3_new = v3 + theta * divergence(state.p31, state.p32)
    else:
        u3_new = u3

    err = ((u1_new - u1) ** 2 + (u2_new - u2) ** 2).sum(dim=(-2, -1))

    # Dual ascent with pointwise projection.
    u1x, u1y = forward_gradient(u1_new)
    u2x, u2y = forward_gradient(u2_new)
    ng1 = 1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y)
    ng2 = 1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y)
    p11 = (state.p11 + taut * u1x) / ng1
    p12 = (state.p12 + taut * u1y) / ng1
    p21 = (state.p21 + taut * u2x) / ng2
    p22 = (state.p22 + taut * u2y) / ng2

    if use_gamma:
        u3x, u3y = forward_gradient(u3_new)
        ng3 = 1.0 + taut * torch.sqrt(u3x * u3x + u3y * u3y)
        p31 = (state.p31 + taut * u3x) / ng3
        p32 = (state.p32 + taut * u3y) / ng3
    else:
        p31, p32 = state.p31, state.p32

    return (
        _LevelState(u1_new, u2_new, u3_new, p11, p12, p21, p22, p31, p32),
        err,
    )


def level_solve_plain(
    i0: torch.Tensor,  # (N, H, W)
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
    u3: Optional[torch.Tensor] = None,
    exit_every: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run warps x iterations primal-dual at one pyramid level for a batch.

    Returns (u1, u2, u3, iterations run per image ``(N,)`` int32, summed
    over the warps). With ``epsilon > 0`` an image stops updating once its
    own error meets the criterion; the rest of the batch goes on.

    ``exit_every = k`` tests the criterion only after every k-th iteration
    of a sweep, on that iteration's error: the rule of the blocked level
    kernel, whose chunks of k iterations run whole."""
    l_t = params.lambda_ * params.theta
    taut = params.tau / params.theta
    n, h, w = i0.shape
    scaled_eps = params.epsilon * params.epsilon * h * w
    use_eps = params.epsilon > 0

    with torch.no_grad():
        i1x, i1y = centered_gradient(i1)
        zeros = torch.zeros_like(i0)
        if u3 is None:
            u3 = zeros
        state = _LevelState(u1, u2, u3, *([zeros] * 6))
        iters = torch.zeros(n, dtype=torch.int32, device=i0.device)

        for _ in range(params.warps):
            _, i1wx, i1wy, grad, rho_c = warp_backward(
                i0, i1, i1x, i1y, state.u1, state.u2
            )
            active = torch.ones(n, dtype=torch.bool, device=i0.device)
            for it in range(params.iterations):
                new, err = _iteration(
                    state, i1wx, i1wy, grad, rho_c, l_t, params.theta, taut,
                    params.gamma,
                )
                if not use_eps:
                    state = new
                    iters += 1
                    continue
                keep = active[:, None, None]
                state = _LevelState(
                    *(torch.where(keep, a, b) for a, b in zip(new, state))
                )
                iters += active.to(torch.int32)
                if (it + 1) % exit_every != 0:
                    continue
                active = active & (err > scaled_eps)
                if not bool(active.any()):
                    break
    return state.u1, state.u2, state.u3, iters


def tvl1_flow_level(
    i0: torch.Tensor,
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    params: TVL1Params,
    u3: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-level solve of one ``(H, W)`` image or an ``(N, H, W)`` batch
    with the plain solver. Returns (u1, u2, u3)."""
    if i0.dim() == 2:
        a, b, c, _ = level_solve_plain(
            i0[None], i1[None], u1[None], u2[None], params,
            u3=None if u3 is None else u3[None],
        )
        return a[0], b[0], c[0]
    a, b, c, _ = level_solve_plain(i0, i1, u1, u2, params, u3=u3)
    return a, b, c


# level_solver(i0, i1, u1, u2, params, u3) -> (u1, u2, u3, iters) on (N, H, W)
LevelSolver = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]

_last_iteration_stats: List[Tuple[Tuple[int, int], torch.Tensor]] = []


def get_last_iteration_stats() -> List[Tuple[Tuple[int, int], torch.Tensor]]:
    """Per-level ``((h, w), iterations run per image (N,) int32)`` of the
    most recent :func:`solve_pyramid` call, coarsest level first. One count
    = one primal-dual iteration over that level's h x w pixels, summed over
    the warps. The tensors stay on the solve's device: reading them
    synchronises with the solve."""
    return list(_last_iteration_stats)


def solve_pyramid(
    i0s: torch.Tensor,  # (N, H, W)
    i1s: torch.Tensor,
    params: TVL1Params,
    init_flow: Optional[torch.Tensor],  # (N, H, W, 2)
    level_solver: LevelSolver,
) -> torch.Tensor:
    """The coarse-to-fine loop shared by the plain solver and the kernel
    path: both pyramids built once from the stacked ``(2N, H, W)`` frames,
    levels solved coarse to fine, flow upscaled by 1/scale_step between
    them. Returns the ``(N, H, W, 2)`` flow, ``[..., 0]`` = x."""
    global _last_iteration_stats
    n, h, w = i0s.shape
    shapes = pyramid_shapes(h, w, params.nscales, params.scale_step)
    with torch.no_grad():
        stacked = torch.cat([i0s, i1s], dim=0).to(torch.float32)
        levels = build_pyramid(stacked, shapes)

        coarsest = shapes[-1]
        if params.use_initial_flow and init_flow is not None:
            u1 = init_flow[..., 0]
            u2 = init_flow[..., 1]
            for shape in shapes[1:]:
                u1 = resize_bilinear(u1, shape) * params.scale_step
                u2 = resize_bilinear(u2, shape) * params.scale_step
        else:
            u1 = torch.zeros((n,) + coarsest, dtype=torch.float32,
                             device=i0s.device)
            u2 = torch.zeros_like(u1)
        u3 = torch.zeros_like(u1)

        stats = []
        for s in range(len(shapes) - 1, -1, -1):
            lvl = levels[s]
            u1, u2, u3, iters = level_solver(
                lvl[:n].contiguous(), lvl[n:].contiguous(),
                u1.contiguous(), u2.contiguous(), params, u3,
            )
            stats.append((shapes[s], iters))
            if s > 0:
                u1, u2 = upscale_flow(u1, u2, shapes[s - 1], params.scale_step)
                if params.gamma != 0.0:
                    u3 = resize_bilinear(u3, shapes[s - 1])
                else:
                    u3 = torch.zeros_like(u1)
        _last_iteration_stats = stats
        return torch.stack([u1, u2], dim=-1)


def default_level_solver(*example_args: torch.Tensor):
    """The per-level solver for :func:`tvl1_flow`'s ``level_solver``
    argument that suits where the example tensors lie: the chunk-kernel
    level solve (ops/tvl1_chunk_cuda.py) for CUDA tensors, the plain
    :func:`tvl1_flow_level` for CPU tensors. The device alone decides."""
    if any(t is not None and t.is_cuda for t in example_args):
        from optflow_tpu_torch.ops.tvl1_chunk_cuda import tvl1_flow_level_cuda

        return tvl1_flow_level_cuda
    return tvl1_flow_level


def tvl1_flow(
    i0: torch.Tensor,
    i1: torch.Tensor,
    params: TVL1Params = TVL1Params(),
    init_flow: Optional[torch.Tensor] = None,
    level_solver=None,
) -> torch.Tensor:
    """Full coarse-to-fine TV-L1 flow from i0 to i1.

    Args:
      i0, i1: (H, W) float32 grayscale frames, 0..255 intensity scale.
      params: solver parameters (reference defaults).
      init_flow: optional (H, W, 2) initial flow, honored when
        ``params.use_initial_flow`` (the reference's useInitialFlow key).
      level_solver: optional per-level solver with the signature of
        :func:`tvl1_flow_level` on one ``(H, W)`` image, as
        :func:`default_level_solver` returns. Without it the solve goes
        through :func:`tvl1_flow_batched`.

    Returns:
      (H, W, 2) float32 flow with [..., 0] = x displacement, [..., 1] = y,
      matching the reference's CV_32FC2 flow layout split at
      src/optflow.cpp:403-404.
    """
    flow_init = None if init_flow is None else init_flow[None]
    if level_solver is None:
        return tvl1_flow_batched(i0[None], i1[None], params, init_flow=flow_init)[0]

    def one_image(a, b, u1, u2, p, u3):
        r1, r2, r3 = level_solver(a[0], b[0], u1[0], u2[0], p, u3=u3[0])
        # a solver of this signature does not report its iteration counts
        unknown = torch.full((1,), -1, dtype=torch.int32, device=a.device)
        return r1[None], r2[None], r3[None], unknown

    return solve_pyramid(i0[None], i1[None], params, flow_init, one_image)[0]


def tvl1_flow_batched(
    i0s: torch.Tensor,  # (N, H, W)
    i1s: torch.Tensor,
    params: TVL1Params = TVL1Params(),
    init_flow: Optional[torch.Tensor] = None,  # (N, H, W, 2)
) -> torch.Tensor:
    """Batched coarse-to-fine TV-L1 over a leading pair axis.

    CUDA tensors with ``gamma == 0`` take the hand-written level kernel
    (ops/tvl1_cuda.py); CPU tensors, and ``gamma != 0`` (which the kernel
    does not solve), take the plain solver of this module. The device of
    ``i0s`` alone decides: a CUDA tensor never falls back on a failure."""
    if i0s.is_cuda and params.gamma == 0.0:
        from optflow_tpu_torch.ops.tvl1_cuda import tvl1_flow_batched_cuda

        return tvl1_flow_batched_cuda(i0s, i1s, params, init_flow=init_flow)
    return solve_pyramid(i0s, i1s, params, init_flow, level_solve_plain)
