"""The port's chunk kernel (through its plain version) and the per-level
solve built on it, against the JAX package's legacy chunk kernel run in
interpret mode, on the CPU, on the same numpy inputs."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi
import torch

from optflow_tpu.core.config import TVL1Params as JaxParams
from optflow_tpu.ops import tvl1 as jtv
from optflow_tpu.ops import tvl1_pallas as jtp
from optflow_tpu.ops.warp import centered_gradient as j_centered_gradient
from optflow_tpu.ops.warp import warp_backward as j_warp_backward
from optflow_tpu_torch import convert
from optflow_tpu_torch.ops import tvl1 as ttv
from optflow_tpu_torch.ops import tvl1_chunk_cuda as tcc
from tests.conftest import make_fibsem_like
from tests.test_tvl1 import translate

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)


def _params(**kw):
    jp = JaxParams(**kw)
    return jp, convert.params_from_reference(dataclasses.asdict(jp))


def _pairs(rng, n, h, w):
    i0 = np.stack([make_fibsem_like(rng, h, w) for _ in range(n)])
    i1 = np.stack([translate(a, 0.6 + 0.5 * k, -0.4 * (k + 1))
                   for k, a in enumerate(i0)])
    return i0, i1


def _chunk_inputs(rng, n, h, w):
    """ro from the JAX package's own warp of a real pair at a smooth flow,
    and a state with non-zero duals: numpy arrays, unpadded."""
    i0, i1 = _pairs(rng, n, h, w)
    u = ndi.gaussian_filter(rng.standard_normal((2, n, h, w)), (0, 0, 4, 4))
    u = (1.2 * u / np.abs(u).max()).astype(np.float32)
    p = ndi.gaussian_filter(rng.standard_normal((4, n, h, w)), (0, 0, 2, 2))
    p = (0.5 * p / np.abs(p).max()).astype(np.float32)
    ros = []
    for k in range(n):
        i1x, i1y = j_centered_gradient(jnp.asarray(i1[k]))
        _, wx, wy, _, rho = j_warp_backward(
            jnp.asarray(i0[k]), jnp.asarray(i1[k]), i1x, i1y,
            jnp.asarray(u[0, k]), jnp.asarray(u[1, k]),
        )
        ros.append(np.stack([np.asarray(wx), np.asarray(wy), np.asarray(rho)]))
    state = np.concatenate([u, p]).transpose(1, 0, 2, 3)  # (n, 6, h, w)
    return np.stack(ros).astype(np.float32), np.ascontiguousarray(state)


def _run_jax_chunk(ro, state, m, thresh, geo, jp):
    h, w = ro.shape[-2:]
    ro_c = convert.tensor_to_canvas(torch.from_numpy(ro), geo.hp, geo.wp)
    st_c = convert.tensor_to_canvas(torch.from_numpy(state), geo.hp, geo.wp)
    new, errs = jtp._run_chunk(
        jnp.asarray(ro_c), jnp.asarray(st_c), jnp.int32(m), jnp.int32(h),
        jnp.int32(w), jnp.float32(thresh), geo=geo,
        l_t=float(jp.lambda_ * jp.theta), theta=float(jp.theta),
        taut=float(jp.tau / jp.theta), interpret=True,
    )
    return convert.canvas_to_tensor(np.asarray(new), h, w, device="cpu"), \
        np.asarray(errs)


def test_chunk_tiles_match_tpu_chunk_kernel_in_interpret_mode(rng):
    """Multi-block, m = 8: the JAX kernel on 3 row blocks with an 8-row halo,
    the port on 3 x 3 tiles of 32 x 64. New state within 1e-5, the per-image
    error (the blocks' sum) within 1e-4 relative: the same arithmetic in
    float32, summed over other blocks."""
    n, h, w = 2, 70, 150
    jp, tp = _params(nscales=1)
    ro, state = _chunk_inputs(rng, n, h, w)
    geo = jtp._Geometry(hp=72, wp=256, block=24, halo=8, win=40, nb=3)
    want, want_errs = _run_jax_chunk(ro, state, 8, -1.0, geo, jp)
    tgeo = tcc.chunk_geometry(h, w)
    assert not tgeo.one_block and tgeo.blocks == 9
    iters = torch.zeros(n, dtype=torch.int32)
    got, errs = tcc.tvl1_chunk(
        torch.from_numpy(ro), torch.from_numpy(state), 8, -1.0, tp,
        iters=iters,
    )
    assert errs.shape == (n, 9) and iters.tolist() == [8, 8]
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got[:, :2] - torch.from_numpy(state)[:, :2]).abs().max()) > 0.01
    rel = np.abs(errs.sum(1).numpy() - want_errs.sum(1)) / want_errs.sum(1)
    assert rel.max() <= 1e-4


def test_chunk_one_block_exit_matches_tpu_chunk_kernel(rng):
    """One block, in-kernel `while (it < m && err > thresh)`: both leave the
    loop at the same iteration (the state within 1e-5 says so: one
    iteration more moves it by far more) with the same last error."""
    n, h, w = 2, 34, 60
    jp, tp = _params(nscales=1)
    ro, state = _chunk_inputs(rng, n, h, w)
    geo = jtp._select_geometry(h, w)
    assert geo.nb == 1
    thresh = 0.03 ** 2 * h * w
    want, want_errs = _run_jax_chunk(ro, state, 200, thresh, geo, jp)
    assert tcc.chunk_geometry(h, w).one_block
    iters = torch.zeros(n, dtype=torch.int32)
    got, errs = tcc.tvl1_chunk(
        torch.from_numpy(ro), torch.from_numpy(state), 200, thresh, tp,
        iters=iters,
    )
    assert all(0 < c < 200 for c in iters.tolist())  # the exit was taken
    assert len(set(iters.tolist())) == 2  # each image at its own iteration
    assert float((got - want).abs().max()) <= 1e-5
    assert errs.shape == (n, 1) and bool((errs <= thresh).all())
    rel = np.abs(errs.numpy() - want_errs) / want_errs
    assert rel.max() <= 1e-4
    # one more iteration would have been seen
    more, _ = tcc.tvl1_chunk_plain(
        torch.from_numpy(ro), got.contiguous(), 1, -1.0, tp)
    assert float((more - got).abs().max()) > 1e-4


def test_chunk_stopped_image_passes_through(rng):
    n, h, w = 3, 40, 200
    _, tp = _params(nscales=1)
    ro, state = _chunk_inputs(rng, n, h, w)
    ro, state = torch.from_numpy(ro), torch.from_numpy(state)
    active = torch.tensor([1, 0, 1], dtype=torch.int32)
    iters = torch.full((n,), 5, dtype=torch.int32)
    got, errs = tcc.tvl1_chunk(ro, state, 4, -1.0, tp, active=active, iters=iters)
    full, full_errs = tcc.tvl1_chunk(ro, state, 4, -1.0, tp)
    assert torch.equal(got[1], state[1]) and float(errs[1].abs().max()) == 0.0
    assert torch.equal(got[0], full[0]) and torch.equal(errs[2], full_errs[2])
    assert iters.tolist() == [9, 5, 9]


@pytest.mark.parametrize(
    "shape,epsilon", [((70, 150), 0.0), ((34, 60), 0.01)],
    ids=["tiles-fixed-count", "one-block-epsilon-exit"],
)
def test_chunk_level_solve_matches_pallas_level_path(rng, shape, epsilon):
    """tvl1_flow_level_cuda_batched on CPU tensors against
    tvl1_flow_level_pallas_batched(interpret=True, shift_warp=False), within
    1e-4 px: in tiles at a fixed count (the JAX package runs this size in
    one block, whose per-iteration exit the tile mode does not have), and in
    one block with the per-image epsilon exit on both sides."""
    h, w = shape
    n = 2
    i0, i1 = _pairs(rng, n, h, w)
    jp, tp = _params(nscales=1, warps=3, iterations=40, epsilon=epsilon)
    z = jnp.zeros((n, h, w), jnp.float32)
    w1, w2, _ = jtp.tvl1_flow_level_pallas_batched(
        jnp.asarray(i0), jnp.asarray(i1), z, z, jp, interpret=True,
        shift_warp=False,
    )
    zt = torch.zeros(n, h, w)
    g1, g2, g3, iters = tcc.tvl1_flow_level_cuda_batched(
        torch.from_numpy(i0), torch.from_numpy(i1), zt, zt, tp,
        return_iters=True,
    )
    assert tcc.chunk_geometry(h, w).one_block == (epsilon > 0)
    assert np.abs(g1.numpy() - np.asarray(w1)).max() <= 1e-4
    assert np.abs(g2.numpy() - np.asarray(w2)).max() <= 1e-4
    assert float(g3.abs().max()) == 0.0
    assert np.abs(g1.numpy()).max() > 0.3  # the solve moved the flow
    if epsilon > 0:
        assert all(0 < c < 120 for c in iters.tolist())
    else:
        assert iters.tolist() == [120, 120]


def test_chunk_level_solve_tiles_stop_each_image_at_a_chunk_boundary(rng):
    """Tile mode with epsilon: an image stops after the first chunk whose
    last error meets the criterion; the counts are whole chunks, each image
    its own, and never below the exact per-iteration count."""
    n, h, w = 2, 70, 150
    i0, i1 = _pairs(rng, n, h, w)
    i1[1] = translate(i0[1], 0.2, 0.0)
    _, tp = _params(nscales=1, warps=2, iterations=100, epsilon=0.02)
    zt = torch.zeros(n, h, w)
    args = (torch.from_numpy(i0), torch.from_numpy(i1), zt, zt, tp)
    *_, iters = tcc.tvl1_flow_level_cuda_batched(*args, return_iters=True)
    *_, exact = ttv.level_solve_plain(*args)
    *_, every8 = ttv.level_solve_plain(*args, exit_every=tcc.CHUNK_K)
    assert iters.tolist() == every8.tolist()
    assert all(c % tcc.CHUNK_K in (0, 100 % tcc.CHUNK_K) for c in iters.tolist())
    assert all(a >= b for a, b in zip(iters.tolist(), exact.tolist()))
    assert iters[0] != iters[1] and int(iters.max()) < 200


def test_chunk_level_solve_single_image_and_gamma(rng):
    h, w = 34, 60
    i0, i1 = _pairs(rng, 1, h, w)
    _, tp = _params(nscales=1, warps=2, iterations=10)
    zt = torch.zeros(h, w)
    a = tcc.tvl1_flow_level_cuda(
        torch.from_numpy(i0[0]), torch.from_numpy(i1[0]), zt, zt, tp)
    b = tcc.tvl1_flow_level_cuda_batched(
        torch.from_numpy(i0), torch.from_numpy(i1), zt[None], zt[None], tp)
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))
    _, tg = _params(nscales=1, warps=2, iterations=10, gamma=0.5)
    g = tcc.tvl1_flow_level_cuda(
        torch.from_numpy(i0[0]), torch.from_numpy(i1[0]), zt, zt, tg)
    want = ttv.tvl1_flow_level(
        torch.from_numpy(i0[0]), torch.from_numpy(i1[0]), zt, zt, tg)
    assert all(torch.equal(x, y) for x, y in zip(g, want))
    assert float(g[2].abs().max()) > 0


@pytest.mark.parametrize("solver", ["default", "chunk"])
def test_tvl1_flow_level_solver_matches_jax(rng, solver):
    """tvl1_flow(level_solver=...) against the JAX package's tvl1_flow with
    level_solver=tvl1_flow_level, (64, 96), 3 scales: within 0.02 px (the
    tolerance of the whole-pyramid comparison). Every level of this size
    runs the chunk-kernel level solve in one block, whose exit is the exact one."""
    im0 = make_fibsem_like(rng, 64, 96)
    im1 = translate(im0, 1.5, 1.0)
    jp, tp = _params(nscales=3, warps=3, iterations=50)
    want = np.asarray(jtv.tvl1_flow(
        jnp.asarray(im0), jnp.asarray(im1), jp,
        level_solver=jtv.tvl1_flow_level,
    ))
    t0, t1 = torch.from_numpy(im0), torch.from_numpy(im1)
    if solver == "default":
        level_solver = ttv.default_level_solver(t0, t1)
        assert level_solver is ttv.tvl1_flow_level  # CPU tensors
    else:
        level_solver = tcc.tvl1_flow_level_cuda
    got = ttv.tvl1_flow(t0, t1, tp, level_solver=level_solver).numpy()
    assert got.shape == (64, 96, 2)
    assert np.abs(got - want).max() <= 0.02
    assert np.hypot(got[..., 0] - 1.5, got[..., 1] - 1.0).mean() <= 0.5
    # without a level solver the call goes through the batched entry
    plain = ttv.tvl1_flow(t0, t1, tp).numpy()
    assert np.abs(plain - want).max() <= 0.02


@pytest.mark.parametrize(
    "fault,exc",
    [("dtype", TypeError), ("ro-shape", ValueError), ("rank", ValueError),
     ("m-past-halo", ValueError), ("active-dtype", TypeError)],
)
def test_chunk_wrapper_rejects_what_the_kernel_does_not_take(fault, exc):
    _, tp = _params(nscales=1)
    state = torch.zeros(2, 6, 40, 200)
    ro = torch.zeros(2, 3, 40, 200)
    kw = {}
    m = 4
    if fault == "dtype":
        state = state.double()
    elif fault == "ro-shape":
        ro = torch.zeros(2, 3, 40, 100)
    elif fault == "rank":
        state = state[0]
    elif fault == "m-past-halo":
        m = tcc.CHUNK_K + 1
    else:
        kw["active"] = torch.ones(2)
    with pytest.raises(exc):
        tcc.tvl1_chunk(ro, state, m, -1.0, tp, **kw)


def test_canvas_converters_round_trip(rng):
    t = torch.from_numpy(rng.standard_normal((2, 6, 5, 7)).astype(np.float32))
    canvas = convert.tensor_to_canvas(t, 8, 128)
    assert canvas.shape == (2, 6, 8, 128) and canvas.dtype == np.float32
    assert float(np.abs(canvas[:, :, 5:]).max()) == 0.0
    assert float(np.abs(canvas[:, :, :, 7:]).max()) == 0.0
    back = convert.canvas_to_tensor(canvas, 5, 7, device="cpu")
    assert torch.equal(back, t) and back.is_contiguous()
    with pytest.raises(ValueError):
        convert.canvas_to_tensor(canvas, 9, 7, device="cpu")
    with pytest.raises(ValueError):
        convert.tensor_to_canvas(t, 4, 128)


@pytest.mark.gpu
def test_chunk_kernel_matches_plain_version_on_the_card(rng):
    """The CUDA kernel against its plain version, on the GPU, in both modes
    (state within 1e-4). `python3 chip_smoke.py` runs the same comparison at
    the product's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    _, tp = _params(nscales=1)
    for (n, h, w), m, thresh in (((2, 70, 150), 8, -1.0),
                                 ((2, 34, 60), 200, 0.03 ** 2 * 34 * 60)):
        ro, state = _chunk_inputs(rng, n, h, w)
        ro, state = torch.from_numpy(ro).cuda(), torch.from_numpy(state).cuda()
        before = tcc.tvl1_chunk.launches
        ki = torch.zeros(n, dtype=torch.int32, device="cuda")
        pi = torch.zeros_like(ki)
        ks, ke = tcc.tvl1_chunk(ro, state, m, thresh, tp, iters=ki)
        ps, pe = tcc.tvl1_chunk_plain(ro, state, m, thresh, tp, iters=pi)
        assert tcc.tvl1_chunk.launches == before + 1
        assert float((ks - ps).abs().max()) <= 1e-4
        assert torch.equal(ki, pi)
        assert torch.allclose(ke.sum(1), pe.sum(1), rtol=1e-3)
