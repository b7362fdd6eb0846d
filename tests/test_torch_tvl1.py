"""The port's TV-L1 solver against the JAX package's, on the CPU: the level
solve (the function the CUDA kernel computes, through its plain version),
the batch with per-image exit, the whole pyramid and the gamma path."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from optflow_tpu.core.config import TVL1Params as JaxParams
from optflow_tpu.ops import tvl1 as jtv
from optflow_tpu.ops.warp import centered_gradient as j_centered_gradient
from optflow_tpu.ops.warp import warp_backward as j_warp_backward
from optflow_tpu_torch import convert
from optflow_tpu_torch.ops import tvl1 as ttv
from optflow_tpu_torch.ops.tvl1_cuda import (
    tvl1_level_solve,
    tvl1_level_solve_plain,
)
from tests.conftest import make_fibsem_like
from tests.test_tvl1 import translate

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

H, W = 40, 56


def _params(**kw):
    """The same parameters for both packages, carried across by convert."""
    jp = JaxParams(**kw)
    return jp, convert.params_from_reference(dataclasses.asdict(jp))


def _pair(rng, dx, dy, h=H, w=W):
    im0 = make_fibsem_like(rng, h, w)
    return im0, translate(im0, dx, dy)


def _jax_level_with_count(i0, i1, jp):
    """The jnp level solve run iteration by iteration with the package's own
    ``_iteration`` and ``warp_backward``, so that the iteration count of its
    epsilon exit can be read."""
    i0, i1 = jnp.asarray(i0), jnp.asarray(i1)
    l_t = jp.lambda_ * jp.theta
    taut = jp.tau / jp.theta
    thresh = jp.epsilon * jp.epsilon * i0.shape[0] * i0.shape[1]
    i1x, i1y = j_centered_gradient(i1)
    z = jnp.zeros_like(i0)
    state = jtv._LevelState(z, z, z, z, z, z, z, z, z)
    step = jax.jit(
        lambda st, a, b, g, r: jtv._iteration(
            st, a, b, g, r, l_t, jp.theta, taut, jp.gamma
        )
    )
    count = 0
    for _ in range(jp.warps):
        _, a, b, g, r = j_warp_backward(i0, i1, i1x, i1y, state.u1, state.u2)
        for _ in range(jp.iterations):
            state, err = step(state, a, b, g, r)
            count += 1
            if not float(err) > thresh:
                break
    return np.asarray(state.u1), np.asarray(state.u2), count


def test_level_solve_fixed_count_matches_jnp(rng):
    """epsilon = 0, 3 warps x 50 iterations at (40, 56): within 2e-3 px
    (same arithmetic, other fusion and summation order, 150 accumulating
    iterations)."""
    im0, im1 = _pair(rng, 1.5, -0.5)
    jp, tp = _params(nscales=1, warps=3, iterations=50, epsilon=0.0)
    z = jnp.zeros((H, W), jnp.float32)
    a1, a2, _ = jtv.tvl1_flow_level(jnp.asarray(im0), jnp.asarray(im1), z, z, jp)
    state = convert.level_state_from_numpy(
        np.zeros((1, H, W)), np.zeros((1, H, W)), device="cpu"
    )
    i0 = torch.from_numpy(im0[None])
    i1 = torch.from_numpy(im1[None])
    b1, b2, iters = tvl1_level_solve(
        i0, i1, state[:, 0].contiguous(), state[:, 1].contiguous(), tp
    )
    got = convert.flow_to_numpy((b1, b2))
    assert iters.tolist() == [150]
    assert np.abs(got[0, ..., 0] - np.asarray(a1)).max() <= 2e-3
    assert np.abs(got[0, ..., 1] - np.asarray(a2)).max() <= 2e-3
    assert np.abs(got[0, ..., 0]).max() > 0.5  # the solve moved the flow


def test_level_solve_epsilon_exit_matches_jnp(rng):
    """epsilon = 0.01: the same iteration count (+-1: the error sums are
    taken in another order) and the same flow within 5e-3 px."""
    im0, im1 = _pair(rng, 1.5, -0.5)
    jp, tp = _params(nscales=1, warps=3, iterations=50, epsilon=0.01)
    z = jnp.zeros((H, W), jnp.float32)
    a1, a2, _ = jtv.tvl1_flow_level(jnp.asarray(im0), jnp.asarray(im1), z, z, jp)
    c1, c2, count = _jax_level_with_count(im0, im1, jp)
    # the counted loop is the same solve as the package's while_loop
    assert np.abs(c1 - np.asarray(a1)).max() <= 1e-4
    zt = torch.zeros(1, H, W)
    b1, b2, iters = tvl1_level_solve_plain(
        torch.from_numpy(im0)[None], torch.from_numpy(im1)[None], zt, zt, tp
    )
    assert 0 < count < 150  # the exit was taken
    assert abs(int(iters[0]) - count) <= 1
    assert np.abs(b1[0].numpy() - np.asarray(a1)).max() <= 5e-3
    assert np.abs(b2[0].numpy() - np.asarray(a2)).max() <= 5e-3


def test_level_solve_matches_fused_tpu_kernel_in_interpret_mode(rng):
    """Against the TPU kernel this port's kernel replaces, run as the JAX
    package's own test runs it on the CPU (interpret mode), with an
    in-contract flow.

    The fused kernel samples with the shift-compose warp, which evaluates
    the x taps at the source row (ops/warp.py, warp_backward_shift: an
    approximation where the flow varies); the port gathers exactly. So the
    two agree to 0.01 px in the mean and 0.1 px at the worst pixel, while
    the same Pallas level path run with the exact gather warp
    (shift_warp=False) agrees with the port to 1e-4 px — and differs from
    the fused kernel by as much as the port does."""
    from optflow_tpu.ops.tvl1_pallas import (
        _fused_level_fn,
        tvl1_flow_level_pallas_batched,
    )

    im0, im1 = _pair(rng, 1.5, -0.5)
    jp, tp = _params(nscales=1, warps=3, iterations=50)
    u = jnp.zeros((1, H, W), jnp.float32)
    j0, j1 = jnp.asarray(im0)[None], jnp.asarray(im1)[None]
    step = _fused_level_fn(1, (H, W), None, jp, True, 8)
    fu1, fu2, viol, iters, _mx = step(j0, j1, u, u)
    assert int(viol[0]) == 0
    zt = torch.zeros(1, H, W)
    b1, b2, titers = tvl1_level_solve(
        torch.from_numpy(im0)[None], torch.from_numpy(im1)[None], zt, zt, tp
    )
    for got, fused in ((b1, fu1), (b2, fu2)):
        d = np.abs(got[0].numpy() - np.asarray(fused[0]))
        assert d.mean() < 0.01
        assert d.max() < 0.1
    assert abs(int(titers[0]) - int(iters[0])) <= 3

    e1, e2, _ = tvl1_flow_level_pallas_batched(
        j0, j1, u, u, jp, interpret=True, shift_warp=False
    )
    assert np.abs(b1[0].numpy() - np.asarray(e1[0])).max() < 1e-4
    assert np.abs(b2[0].numpy() - np.asarray(e2[0])).max() < 1e-4


def test_batch_exits_per_image_like_vmapped_jnp(rng):
    """Three images that converge at different iterations: the port's
    batched solve stops each on its own criterion, as jax.vmap of the
    while_loop does. Flow within 5e-3 px of the JAX package's
    tvl1_flow_batched."""
    im0 = make_fibsem_like(rng, H, W)
    i0 = np.stack([im0] * 3)
    i1 = np.stack([translate(im0, 0.3, 0.0), translate(im0, 1.0, -0.5),
                   translate(im0, 2.0, 1.0)])
    jp, tp = _params(nscales=1, warps=2, iterations=80, epsilon=0.02)
    want = np.asarray(jtv.tvl1_flow_batched(jnp.asarray(i0), jnp.asarray(i1), jp))
    got = ttv.tvl1_flow_batched(torch.from_numpy(i0), torch.from_numpy(i1), tp)
    (shape, iters), = ttv.get_last_iteration_stats()
    assert shape == (H, W)
    assert len(set(iters.tolist())) == 3  # each image took its own exit
    assert max(iters.tolist()) < 160
    assert np.abs(convert.flow_to_numpy(got) - want).max() <= 5e-3
    # each image of the batch equals its own batch-1 solve
    for k in range(3):
        solo = ttv.tvl1_flow(torch.from_numpy(i0[k]), torch.from_numpy(i1[k]), tp)
        assert torch.equal(solo, got[k])


def test_whole_pyramid_matches_jnp(rng):
    """(2, 64, 96), 3 scales: within 0.02 px of the JAX package, and mean
    EPE <= 0.5 px against the known translation."""
    ims0 = np.stack([make_fibsem_like(rng, 64, 96) for _ in range(2)])
    ims1 = np.stack([translate(x, 1.5, 1.0) for x in ims0])
    jp, tp = _params(nscales=3, warps=3, iterations=50)
    want = np.asarray(
        jtv.tvl1_flow_batched(jnp.asarray(ims0), jnp.asarray(ims1), jp)
    )
    got = convert.flow_to_numpy(
        ttv.tvl1_flow_batched(
            torch.from_numpy(ims0), torch.from_numpy(ims1), tp,
        )
    )
    assert got.shape == (2, 64, 96, 2)
    assert np.abs(got - want).max() <= 0.02
    epe = np.hypot(got[..., 0] - 1.5, got[..., 1] - 1.0).mean()
    assert epe <= 0.5
    stats = ttv.get_last_iteration_stats()
    assert [s for s, _ in stats] == [(41, 62), (51, 77), (64, 96)]


def test_initial_flow_is_honoured_like_jnp(rng):
    ims0 = np.stack([make_fibsem_like(rng, 48, 64)])
    ims1 = np.stack([translate(ims0[0], 1.0, 0.5)])
    init = np.zeros((1, 48, 64, 2), np.float32)
    init[..., 0], init[..., 1] = 1.0, 0.5
    jp, tp = _params(nscales=2, warps=1, iterations=5, use_initial_flow=True)
    want = np.asarray(jtv.tvl1_flow_batched(
        jnp.asarray(ims0), jnp.asarray(ims1), jp, init_flow=jnp.asarray(init)
    ))
    got = ttv.tvl1_flow_batched(
        torch.from_numpy(ims0), torch.from_numpy(ims1), tp,
        init_flow=convert.flow_from_numpy(init, device="cpu"),
    ).numpy()
    assert np.abs(got - want).max() <= 1e-3
    assert np.abs(got[..., 0] - 1.0).mean() < 0.2


def test_gamma_path_matches_jnp(rng):
    """gamma != 0 solves the illumination variable u3 too; the kernel does
    not, so every device takes the plain solver. Within 1e-4."""
    im0, im1 = _pair(rng, 1.0, 0.0, 32, 40)
    jp, tp = _params(nscales=1, warps=2, iterations=10, gamma=0.5)
    z = jnp.zeros((32, 40), jnp.float32)
    a1, a2, a3 = jtv.tvl1_flow_level(jnp.asarray(im0), jnp.asarray(im1), z, z, jp)
    zt = torch.zeros(32, 40)
    b1, b2, b3 = ttv.tvl1_flow_level(
        torch.from_numpy(im0), torch.from_numpy(im1), zt, zt, tp
    )
    assert np.abs(b1.numpy() - np.asarray(a1)).max() <= 1e-4
    assert np.abs(b2.numpy() - np.asarray(a2)).max() <= 1e-4
    assert np.abs(b3.numpy() - np.asarray(a3)).max() <= 1e-4
    assert np.abs(b3.numpy()).max() > 0
    with pytest.raises(ValueError, match="gamma"):
        tvl1_level_solve(zt[None], zt[None], zt[None], zt[None], tp)


@pytest.mark.parametrize(
    "fault,exc",
    [("dtype", TypeError), ("shape", ValueError), ("contiguous", ValueError),
     ("rank", ValueError)],
)
def test_level_solve_wrapper_rejects_what_the_kernel_does_not_take(fault, exc):
    _, tp = _params(nscales=1, warps=1, iterations=1)
    z = torch.zeros(2, 16, 24)
    args = [z, z.clone(), z.clone(), z.clone()]
    if fault == "dtype":
        args[2] = args[2].double()
    elif fault == "shape":
        args[1] = torch.zeros(2, 16, 20)
    elif fault == "contiguous":
        args[3] = torch.zeros(2, 24, 16).transpose(1, 2)
    else:
        args = [a[0] for a in args]
    with pytest.raises(exc):
        tvl1_level_solve(*args, tp)


def test_convert_state_and_flow_layouts(rng):
    u1 = rng.standard_normal((2, 5, 7)).astype(np.float32)
    u2 = rng.standard_normal((2, 5, 7)).astype(np.float32)
    duals = [rng.standard_normal((2, 5, 7)).astype(np.float32) for _ in range(4)]
    st = convert.level_state_from_numpy(u1, u2, duals, device="cpu")
    assert st.shape == (2, 6, 5, 7) and st.dtype == torch.float32
    assert convert.STATE_ORDER == ("u1", "u2", "p11", "p12", "p21", "p22")
    assert np.array_equal(st[:, 1].numpy(), u2)
    assert np.array_equal(st[:, 4].numpy(), duals[2])
    zero = convert.level_state_from_numpy(u1, u2, device="cpu")
    assert float(zero[:, 2:].abs().max()) == 0.0
    flow = convert.flow_to_numpy((st[:, 0], st[:, 1]))
    assert flow.shape == (2, 5, 7, 2)
    assert np.array_equal(flow[..., 0], u1) and np.array_equal(flow[..., 1], u2)
    back = convert.flow_from_numpy(flow, device="cpu")
    assert np.array_equal(convert.flow_to_numpy(back), flow)
    with pytest.raises(ValueError):
        convert.flow_from_numpy(np.zeros((2, 5, 7, 3)), device="cpu")


@pytest.mark.gpu
def test_level_kernel_matches_plain_version_on_the_card(rng):
    """The CUDA kernel against its plain version, on the GPU (1e-3 px at a
    fixed 2 x 25 iterations). `python3 chip_smoke.py` runs the same
    comparison at the product's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    im0, im1 = _pair(rng, 1.0, -0.5, 37, 53)
    _, tp = _params(nscales=1, warps=2, iterations=25, epsilon=0.0)
    i0 = torch.from_numpy(np.stack([im0] * 3)).cuda()
    i1 = torch.from_numpy(np.stack([im1] * 3)).cuda()
    z = torch.zeros_like(i0)
    before = tvl1_level_solve.launches
    k1, k2, kit = tvl1_level_solve(i0, i1, z, z, tp)
    p1, p2, pit = tvl1_level_solve_plain(i0, i1, z, z, tp)
    assert tvl1_level_solve.launches == before + 1
    assert float((k1 - p1).abs().max()) <= 1e-3
    assert float((k2 - p2).abs().max()) <= 1e-3
    assert torch.equal(kit, pit)
