"""The control flow of the port's persistent level grid (the level kernel,
and the blocked and chunk kernels on it with an exit every k and every 8
iterations) and of the chunk kernel's sweep entry, on the CPU: the chunk
schedule, the search for an image's exit inside a chunk, the replay from the
chunk's input and the counts are Python a test can reach. The plain
emulation of the grid's control flow must equal the plain level solve (which
the JAX-against-port tests of ``test_torch_tvl1.py`` hold to the jnp solver)
bit for bit, flow and counts, for every exit period."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optflow_tpu.core.config import TVL1Params as JaxParams
from optflow_tpu.ops import tvl1_pallas as jtp
from optflow_tpu_torch import convert
from optflow_tpu_torch.ops import tvl1 as ttv
from optflow_tpu_torch.ops import tvl1_blocked_cuda as tbc
from optflow_tpu_torch.ops import tvl1_chunk_cuda as tcc
from optflow_tpu_torch.ops import tvl1_cuda as tlc
from optflow_tpu_torch.ops.warp import centered_gradient, warp_backward
from tests.conftest import make_fibsem_like
from tests.test_tvl1 import translate

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)


def _params(**kw):
    jp = JaxParams(**kw)
    return jp, convert.params_from_reference(dataclasses.asdict(jp))


def _level_inputs(rng, n, h, w):
    """``n`` pairs shifted by different amounts, so that the images of a
    batch converge at different iterations; zero entry flow."""
    i0 = np.stack([make_fibsem_like(rng, h, w) for _ in range(n)])
    i1 = np.stack([translate(a, 0.3 + 0.6 * k, -0.25 * (k + 1))
                   for k, a in enumerate(i0)])
    z = torch.zeros(n, h, w)
    return torch.from_numpy(i0), torch.from_numpy(i1), z, z.clone()


def _chunk_of(j, iterations):
    """(start, length) of the schedule's chunk that holds iteration ``j``."""
    start = 0
    for m in tlc.level_chunk_schedule(iterations):
        if j < start + m:
            return start, m
        start += m
    raise AssertionError(f"iteration {j} is past {iterations}")


@pytest.mark.parametrize("iterations", [25, 300])
@pytest.mark.parametrize("epsilon", [0.01, 0.0])
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 40, 56)])
def test_schedule_emulation_equals_plain_level_solve(rng, shape, epsilon,
                                                     iterations):
    """Chunks run speculatively, exits found afterwards, chunks replayed from
    their input: the same flow and the same counts as the plain level solve
    with its per-iteration exit, not one bit apart."""
    _, tp = _params(nscales=1, warps=3, iterations=iterations,
                    epsilon=epsilon)
    args = _level_inputs(rng, *shape)
    p1, p2, pit = tlc.tvl1_level_solve_plain(*args, tp)
    e1, e2, eit, computed = tlc.tvl1_level_solve_schedule_plain(*args, tp)
    assert torch.equal(e1, p1) and torch.equal(e2, p2)
    assert torch.equal(eit, pit) and eit.dtype == torch.int32
    assert bool((computed >= eit).all())
    if epsilon == 0.0:
        assert eit.tolist() == [3 * iterations] * shape[0]
        assert torch.equal(computed, eit)  # nothing to speculate about
    elif iterations == 300:
        assert all(0 < c < 900 for c in eit.tolist())  # every exit was taken
        assert float(p1.abs().max()) > 0.2  # and the solve moved the flow


def test_images_of_a_batch_stop_in_different_chunks(rng):
    """One batch, one sweep, five images whose exits fall into different
    chunks of the schedule: each is replayed (or not) on its own."""
    _, tp = _params(nscales=1, warps=1, iterations=300, epsilon=0.02)
    i0, i1, u1, u2 = _level_inputs(rng, 5, 40, 56)
    p1, p2, pit = tlc.tvl1_level_solve_plain(i0, i1, u1, u2, tp)
    e1, e2, eit, computed = tlc.tvl1_level_solve_schedule_plain(
        i0, i1, u1, u2, tp)
    assert torch.equal(e1, p1) and torch.equal(e2, p2)
    assert torch.equal(eit, pit)
    chunks = {_chunk_of(c - 1, 300)[0] for c in eit.tolist()}
    assert len(chunks) >= 3  # the exits lie in at least three chunks
    for count, comp in zip(eit.tolist(), computed.tolist()):
        start, m = _chunk_of(count - 1, 300)
        last = count == start + m
        # the whole chunk ran; unless the exit was its last iteration, the
        # iterations up to the exit ran once more
        assert comp == start + m + (0 if last else count - start)


def _errors_of_first_sweep(i0, i1, params, count):
    """Per-iteration error of one image's first sweep from zero flow, as the
    plain solver's own ``_iteration`` gives it."""
    l_t = params.lambda_ * params.theta
    taut = params.tau / params.theta
    i1x, i1y = centered_gradient(i1)
    z = torch.zeros_like(i0)
    _, wx, wy, grad, rho = warp_backward(i0, i1, i1x, i1y, z, z)
    st = ttv._LevelState(*([z] * 9))
    errs = []
    for _ in range(count):
        st, err = ttv._iteration(st, wx, wy, grad, rho, l_t, params.theta,
                                 taut, 0.0)
        errs.append(float(err[0]))
    return errs


@pytest.mark.parametrize(
    "exit_at", [0, 1, 4, 5, 7, 12],
    ids=["sweep-first-chunk-first", "sweep-first-chunk-last", "chunk-first",
         "chunk-middle", "chunk-last", "later-chunk-first"],
)
def test_exit_forced_at_a_chosen_iteration_of_a_chunk(rng, exit_at):
    """The threshold is put between the errors of iterations ``exit_at - 1``
    and ``exit_at`` of the first sweep, so the exit falls on a chosen place
    of the schedule's chunks (2, 2, 4, 4, ...): the count is exit_at + 1, the
    flow the plain solve's, and the iterations computed say whether the
    chunk was replayed."""
    assert tlc.LEVEL_SCHEDULE[:3] == (2, 2, 4)
    h, w = 37, 53
    i0, i1, u1, u2 = _level_inputs(rng, 1, h, w)
    _, probe = _params(nscales=1, warps=1, iterations=40, epsilon=0.0)
    errs = _errors_of_first_sweep(i0, i1, probe, exit_at + 1)
    before = min(errs[:exit_at]) if exit_at else 4.0 * errs[0]
    assert errs[exit_at] < before  # the error falls: the exit is the first
    thresh = 0.5 * (errs[exit_at] + before)
    _, tp = _params(nscales=1, warps=1, iterations=40,
                    epsilon=float(np.sqrt(thresh / (h * w))))
    p1, p2, pit = tlc.tvl1_level_solve_plain(i0, i1, u1, u2, tp)
    e1, e2, eit, computed = tlc.tvl1_level_solve_schedule_plain(
        i0, i1, u1, u2, tp)
    assert pit.tolist() == [exit_at + 1]
    assert torch.equal(eit, pit)
    assert torch.equal(e1, p1) and torch.equal(e2, p2)
    start, m = _chunk_of(exit_at, 40)
    replayed = exit_at != start + m - 1
    assert computed.tolist() == [
        start + m + (exit_at - start + 1 if replayed else 0)]


@pytest.mark.parametrize("iterations", [0, 1, 3, 25, 300])
def test_level_chunk_schedule_adds_up(iterations):
    chunks = tlc.level_chunk_schedule(iterations)
    assert sum(chunks) == iterations and all(m >= 1 for m in chunks)
    head = list(tlc.LEVEL_SCHEDULE)
    planned = head + [head[-1]] * max(0, len(chunks) - len(head))
    # every chunk is the planned one, the last possibly cut
    assert chunks[:-1] == planned[:max(len(chunks) - 1, 0)]
    assert not chunks or chunks[-1] <= planned[len(chunks) - 1]
    assert tlc.level_max_steps(5, iterations) == (
        5 * (len(chunks) + 1) if iterations else 0)
    assert tlc.level_tiles(34, 137) == 6 and tlc.level_tiles(256, 1024) == 128
    # two rows of tiles of 17 rows, eight of 32: each with a halo of 4
    assert tlc.level_window_px(34) == 25 * 72
    assert tlc.level_window_px(256) == 40 * 72


@pytest.mark.parametrize("epsilon", [0.01, 0.0])
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 40, 56)])
@pytest.mark.parametrize("exit_every", [1, 3, 8, 16])
def test_periodic_exit_emulation_equals_plain_level_solve(rng, exit_every,
                                                          shape, epsilon):
    """The grid with an exit every E iterations (E = 1: the exact exit, the
    level kernel; 16: the blocked kernel's rule; 8: the chunk kernel's): the
    same flow and counts as level_solve_plain(exit_every=E), not one bit
    apart. With E > 1 every test falls on a chunk's end: nothing is
    speculated or replayed, the iterations computed are those counted."""
    _, tp = _params(nscales=1, warps=3, iterations=100, epsilon=epsilon)
    args = _level_inputs(rng, *shape)
    p1, p2, _, pit = ttv.level_solve_plain(*args, tp, exit_every=exit_every)
    e1, e2, eit, computed = tlc.tvl1_level_solve_schedule_plain(
        *args, tp, exit_every=exit_every)
    assert torch.equal(e1, p1) and torch.equal(e2, p2)
    assert torch.equal(eit, pit)
    if exit_every > 1:
        assert torch.equal(computed, eit)
    if epsilon == 0.0:
        assert eit.tolist() == [300] * shape[0]
    else:
        assert all(0 < c < 300 for c in eit.tolist())  # every exit was taken


@pytest.mark.parametrize("iterations", [1, 7, 32, 300])
@pytest.mark.parametrize("exit_every", [2, 3, 5, 8, 16])
def test_periodic_schedule_ends_a_chunk_at_every_test(exit_every, iterations):
    chunks = tlc.level_chunk_schedule(iterations, exit_every)
    assert sum(chunks) == iterations
    assert all(1 <= m <= tlc.LEVEL_HALO for m in chunks)
    ends = set(np.cumsum(chunks).tolist())
    assert set(range(exit_every, iterations, exit_every)) <= ends
    # no settling step: a sweep is its chunks
    assert tlc.level_max_steps(5, iterations, exit_every) == 5 * len(chunks)
    if exit_every % tlc.LEVEL_HALO == 0:
        assert chunks[:-1] == [tlc.LEVEL_HALO] * (len(chunks) - 1)


def _old_chunk_level_loop(i0, i1, u1, u2, tp, sweep):
    """The chunk kernel's level solve before the level entry: the gradient,
    the state stack and every sweep's warp in PyTorch, one sweep call a
    sweep. ``sweep`` is tvl1_chunk_sweep or its plain version."""
    n, h, w = i0.shape
    thresh = tp.epsilon ** 2 * h * w if tp.epsilon > 0 else -1.0
    i1x, i1y = centered_gradient(i1)
    z = torch.zeros_like(u1)
    state = torch.stack([u1, u2, z, z, z, z], dim=1)
    iters = torch.zeros(n, dtype=torch.int32, device=i0.device)
    for _ in range(tp.warps):
        _, wx, wy, _, rho = warp_backward(i0, i1, i1x, i1y, state[:, 0],
                                          state[:, 1])
        ro = torch.stack([wx, wy, rho], dim=1)
        state, _ = sweep(ro, state, tp.iterations, thresh, tp, iters=iters)
    return state[:, 0], state[:, 1], iters


@pytest.mark.parametrize(
    "shape,epsilon", [((3, 70, 150), 0.02), ((3, 70, 150), 0.0),
                      ((2, 34, 60), 0.02)],
    ids=["tiles-exit", "tiles-no-exit", "one-block-exit"],
)
def test_chunk_level_entry_equals_the_old_sweep_loop(rng, shape, epsilon):
    """The level entry's CPU path (the plain level solve with an exit every
    8 iterations in tiles, every iteration in one block) against the loop
    it replaces (PyTorch warp + tvl1_chunk_sweep_plain a sweep), bit for bit:
    flow and counts."""
    _, tp = _params(nscales=1, warps=3, iterations=60, epsilon=epsilon)
    args = _level_inputs(rng, *shape)
    g1, g2, git = tcc.tvl1_chunk_level_solve(*args, tp)
    o1, o2, oit = _old_chunk_level_loop(*args, tp,
                                          tcc.tvl1_chunk_sweep_plain)
    assert torch.equal(g1, o1) and torch.equal(g2, o2)
    assert torch.equal(git, oit)
    one_block = tcc.chunk_geometry(*shape[1:]).one_block
    assert tcc.level_exit_every(*shape[1:]) == (1 if one_block else 8)
    if epsilon == 0.0:
        assert git.tolist() == [180] * shape[0]
    else:
        assert all(0 < c < 180 for c in git.tolist())
    *_, via_api = tcc.tvl1_flow_level_cuda_batched(*args, tp,
                                                   return_iters=True)
    assert torch.equal(via_api, git)


@pytest.mark.parametrize(
    "fault,exc",
    [("dtype", TypeError), ("contiguous", ValueError), ("shape", ValueError),
     ("gamma", ValueError), ("k-zero", ValueError), ("k-past-16", ValueError)],
)
def test_grid_wrappers_reject_what_the_kernels_do_not_take(fault, exc):
    """The level entries of the blocked and chunk kernels, and their plain
    versions, raise on what the grid does not take; ``gamma != 0`` is no
    kernel's (the level API routes it to the plain solver)."""
    kw = {"nscales": 1, "warps": 1, "iterations": 4}
    if fault == "gamma":
        kw["gamma"] = 0.5
    _, tp = _params(**kw)
    i0 = torch.zeros(2, 40, 70)
    u1 = torch.zeros(2, 40, 70)
    k = tbc.BLOCKED_K
    if fault == "dtype":
        i0 = i0.double()
    elif fault == "contiguous":
        u1 = torch.zeros(2, 70, 40).transpose(1, 2)
    elif fault == "shape":
        u1 = torch.zeros(2, 40, 71)
    elif fault == "k-zero":
        k = 0
    elif fault == "k-past-16":
        k = 17
    args = (i0, torch.zeros(2, 40, 70), u1, torch.zeros(2, 40, 70), tp)
    with pytest.raises(exc):
        tbc.tvl1_blocked_level_solve(*args, k=k)
    with pytest.raises(exc):
        tbc.tvl1_blocked_level_solve_plain(*args, k=k)
    if fault.startswith("k-"):
        return
    with pytest.raises(exc):
        tcc.tvl1_chunk_level_solve(*args)
    with pytest.raises(exc):
        tcc.tvl1_chunk_level_solve_plain(*args)


def test_chunk_level_entry_on_cpu_tensors_counts_no_launch(rng):
    _, tp = _params(nscales=1, warps=1, iterations=8)
    args = _level_inputs(rng, 1, 40, 70)
    before = tcc.tvl1_chunk_level_solve.launches
    got = tcc.tvl1_chunk_level_solve(*args, tp)
    want = tcc.tvl1_chunk_level_solve_plain(*args, tp)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tcc.tvl1_chunk_level_solve.launches == before


def test_no_iterations_leave_the_flow(rng):
    _, tp = _params(nscales=1, warps=2, iterations=0)
    i0, i1, _, _ = _level_inputs(rng, 2, 16, 24)
    u1 = torch.from_numpy(rng.standard_normal((2, 16, 24)).astype(np.float32))
    u2 = u1 * 0.5
    e1, e2, eit, computed = tlc.tvl1_level_solve_schedule_plain(
        i0, i1, u1, u2, tp)
    p1, p2, pit = tlc.tvl1_level_solve_plain(i0, i1, u1, u2, tp)
    assert torch.equal(e1, u1) and torch.equal(e2, u2)
    assert torch.equal(p1, u1) and torch.equal(p2, u2)
    assert eit.tolist() == pit.tolist() == computed.tolist() == [0, 0]


# --------------------------------------------------------------------------
# the chunk kernel's sweep entry
# --------------------------------------------------------------------------


def _sweep_inputs(rng, n, h, w):
    """ro from the port's own warp of pairs that converge at different
    speeds, and the level-entry state (zero flow, zero duals)."""
    i0, i1, u1, u2 = _level_inputs(rng, n, h, w)
    i1x, i1y = centered_gradient(i1)
    _, wx, wy, _, rho = warp_backward(i0, i1, i1x, i1y, u1, u2)
    ro = torch.stack([wx, wy, rho], dim=1).contiguous()
    z = torch.zeros_like(u1)
    return ro, torch.stack([u1, u2, z, z, z, z], dim=1).contiguous()


def _python_chunk_loop(ro, state, iterations, thresh, tp, iters):
    """The loop the level solve ran before the sweep entry: one tvl1_chunk
    call per chunk, later chunks stopped from the errors of the last."""
    active = errs = None
    for done in range(0, iterations, tcc.CHUNK_K):
        m = min(tcc.CHUNK_K, iterations - done)
        state, errs = tcc.tvl1_chunk(ro, state, m, thresh, tp, active=active,
                                     iters=iters)
        if thresh >= 0:
            active = (errs.sum(dim=1) > thresh).to(torch.int32)
    return state, errs


@pytest.mark.parametrize(
    "iterations,epsilon", [(100, 0.02), (21, 0.0), (8, 0.02)],
    ids=["exits-in-different-chunks", "no-exit-ragged-last-chunk",
         "single-chunk"],
)
def test_chunk_sweep_equals_the_loop_over_chunks(rng, iterations, epsilon):
    """Tile mode: state, errors and counts of tvl1_chunk_sweep equal the
    Python loop over tvl1_chunk, bit for bit."""
    n, h, w = 3, 70, 150
    _, tp = _params(nscales=1)
    ro, state = _sweep_inputs(rng, n, h, w)
    assert not tcc.chunk_geometry(h, w).one_block
    thresh = epsilon * epsilon * h * w if epsilon > 0 else -1.0
    it_a = torch.zeros(n, dtype=torch.int32)
    it_b = torch.zeros(n, dtype=torch.int32)
    got, errs = tcc.tvl1_chunk_sweep(ro, state, iterations, thresh, tp,
                                     iters=it_a)
    want, want_errs = _python_chunk_loop(ro, state, iterations, thresh, tp,
                                         it_b)
    assert torch.equal(got, want) and torch.equal(errs, want_errs)
    assert torch.equal(it_a, it_b)
    assert errs.shape == (n, 9)
    if epsilon == 0.0:
        assert it_a.tolist() == [iterations] * n
    elif iterations == 100:
        assert len(set(it_a.tolist())) >= 2  # each image at its own chunk
        assert all(c % tcc.CHUNK_K == 0 for c in it_a.tolist())
        assert int(it_a.min()) < 100
        # an image that had stopped before the last chunk returns zeros
        assert float(errs[int(it_a.argmin())].abs().max()) == 0.0


def test_chunk_sweep_one_block_is_one_chunk_call(rng):
    """A level that fits one block: the sweep is a single chunk call with the
    exit inside, per iteration."""
    n, h, w = 2, 34, 60
    _, tp = _params(nscales=1)
    ro, state = _sweep_inputs(rng, n, h, w)
    assert tcc.chunk_geometry(h, w).one_block
    thresh = 0.03 ** 2 * h * w
    it_a = torch.zeros(n, dtype=torch.int32)
    it_b = torch.zeros(n, dtype=torch.int32)
    got, errs = tcc.tvl1_chunk_sweep(ro, state, 200, thresh, tp, iters=it_a)
    want, want_errs = tcc.tvl1_chunk(ro, state, 200, thresh, tp, iters=it_b)
    assert torch.equal(got, want) and torch.equal(errs, want_errs)
    assert torch.equal(it_a, it_b) and all(0 < c < 200 for c in it_a.tolist())


def test_level_solve_through_the_sweep_matches_pallas_level_path(rng):
    """tvl1_flow_level_cuda_batched, which calls the chunk kernel's level
    entry once a level, against tvl1_flow_level_pallas_batched(
    interpret=True, shift_warp=False) at a size the port runs in tiles:
    within 1e-4 px at a fixed count (the JAX package runs this size in one
    block, whose per-iteration exit the tile mode does not have)."""
    n, h, w = 2, 66, 140
    i0, i1, _, _ = _level_inputs(rng, n, h, w)
    jp, tp = _params(nscales=1, warps=2, iterations=20, epsilon=0.0)
    z = jnp.zeros((n, h, w), jnp.float32)
    w1, w2, _ = jtp.tvl1_flow_level_pallas_batched(
        jnp.asarray(i0.numpy()), jnp.asarray(i1.numpy()), z, z, jp,
        interpret=True, shift_warp=False,
    )
    zt = torch.zeros(n, h, w)
    g1, g2, _, iters = tcc.tvl1_flow_level_cuda_batched(
        i0, i1, zt, zt, tp, return_iters=True)
    assert not tcc.chunk_geometry(h, w).one_block
    assert iters.tolist() == [40, 40]
    assert np.abs(g1.numpy() - np.asarray(w1)).max() <= 1e-4
    assert np.abs(g2.numpy() - np.asarray(w2)).max() <= 1e-4
    assert np.abs(g1.numpy()).max() > 0.1  # the solve moved the flow


@pytest.mark.parametrize(
    "fault,exc",
    [("dtype", TypeError), ("device", ValueError), ("contiguous", ValueError),
     ("ro-shape", ValueError), ("rank", ValueError),
     ("iterations", ValueError), ("iters-dtype", TypeError)],
)
def test_chunk_sweep_wrapper_rejects_what_the_kernel_does_not_take(fault, exc):
    _, tp = _params(nscales=1)
    state = torch.zeros(2, 6, 40, 200)
    ro = torch.zeros(2, 3, 40, 200)
    iterations, kw = 16, {}
    if fault == "dtype":
        ro = ro.double()
    elif fault == "device":
        ro = torch.zeros(2, 3, 40, 200, device="meta")
    elif fault == "contiguous":
        state = torch.zeros(2, 6, 200, 40).transpose(2, 3)
    elif fault == "ro-shape":
        ro = torch.zeros(2, 3, 40, 100)
    elif fault == "rank":
        state = state[0]
    elif fault == "iterations":
        iterations = 0
    else:
        kw["iters"] = torch.zeros(2)
    with pytest.raises(exc):
        tcc.tvl1_chunk_sweep(ro, state, iterations, -1.0, tp, **kw)
    with pytest.raises(exc):
        tcc.tvl1_chunk_sweep_plain(ro, state, iterations, -1.0, tp, **kw)


def test_enqueued_sums_the_tallies_of_the_loaded_libraries(monkeypatch):
    """`_build.enqueued` adds what each loaded library reports through
    `tvl1_enqueued` and passes over a library that does not export it."""
    import ctypes

    from optflow_tpu_torch.ops import _build

    class Tallying:
        def __init__(self, kernels, memops):
            self.counts = (kernels, memops)

        def tvl1_enqueued(self, address):
            out = (ctypes.c_longlong * 2).from_address(address.value)
            out[0], out[1] = self.counts

    class Silent:
        pass

    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.enqueued() == (0, 0)
    monkeypatch.setattr(_build, "_loaded", {
        "a": Tallying(3, 4), "b": Silent(), "c": Tallying(130, 0)})
    assert _build.enqueued() == (133, 4)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_level_kernel_equals_the_blocked_kernel_on_the_card(rng):
    """The level kernel (the grid with the exact exit) against the blocked
    kernel (the same grid, an exit every 16): the same bits at epsilon 0;
    with the exit, the same bits on a rerun, and the counts and iterations
    computed of the plain emulation."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    args = tuple(a.cuda() for a in _level_inputs(rng, 3, 37, 53))
    _, fixed = _params(nscales=1, warps=2, iterations=25, epsilon=0.0)
    k1, k2, kit = tlc.tvl1_level_solve(*args, fixed)
    o1, o2, oit = tbc.tvl1_blocked_level_solve(*args, fixed)
    assert torch.equal(k1, o1) and torch.equal(k2, o2)
    assert torch.equal(kit, oit)
    _, full = _params(nscales=1, warps=3, iterations=300, epsilon=0.01)
    a1, a2, ait = tlc.tvl1_level_solve(*args, full)
    work = tlc.tvl1_level_solve.last_work
    b1, b2, bit = tlc.tvl1_level_solve(*args, full)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert torch.equal(ait, bit)
    e1, e2, eit, computed = tlc.tvl1_level_solve_schedule_plain(*args, full)
    assert float((a1 - e1).abs().max()) <= 1e-3
    assert bool(((ait - eit).abs() <= 1).all())
    assert bool((work[0] >= ait).all())
    steps, grid, *live = tlc.tvl1_level_solve.last_steps.tolist()
    assert 0 < steps <= tlc.level_max_steps(3, 300)
    assert 0 < grid <= 3 * tlc.level_tiles(37, 53)
    assert sum(1 for x in live if x) == steps and max(live) == 3


@pytest.mark.gpu
def test_blocked_kernel_equals_the_kernel_it_replaces_on_the_card(rng):
    """The blocked kernel on the grid against the per-chunk design it
    replaces (the library's second entry point): the same bits at epsilon 0;
    with the exit, counts equal or one chunk apart (the tile sums are added
    in another order), iterations computed equal to those counted, and a
    rerun bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    args = tuple(a.cuda() for a in _level_inputs(rng, 3, 70, 150))
    _, fixed = _params(nscales=1, warps=2, iterations=32, epsilon=0.0)
    before = tbc.tvl1_blocked_level_solve.launches
    k1, k2, kit = tbc.tvl1_blocked_level_solve(*args, fixed)
    o1, o2, oit = tbc.tvl1_blocked_level_solve_per_chunk(*args, fixed)
    assert tbc.tvl1_blocked_level_solve.launches == before + 1
    assert torch.equal(k1, o1) and torch.equal(k2, o2)
    assert torch.equal(kit, oit)
    _, full = _params(nscales=1, warps=3, iterations=300, epsilon=0.01)
    a1, a2, ait = tbc.tvl1_blocked_level_solve(*args, full)
    work = tbc.tvl1_blocked_level_solve.last_work
    b1, b2, bit = tbc.tvl1_blocked_level_solve(*args, full)
    _, _, oit = tbc.tvl1_blocked_level_solve_per_chunk(*args, full)
    _, _, pit = tbc.tvl1_blocked_level_solve_plain(*args, full)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert torch.equal(ait, bit) and torch.equal(work[0], ait)
    for other in (oit, pit):
        assert bool(((ait - other).abs() <= tbc.BLOCKED_K).all())


@pytest.mark.gpu
def test_chunk_level_entry_matches_the_old_sweep_loop_on_the_card(rng):
    """The chunk kernel's level entry against the sweep loop it replaces
    (PyTorch warp + tvl1_chunk_sweep a sweep) and its plain version: one
    library call; counts equal or one test apart (the tile sums are added in
    another order), the flow within 1e-4 px where they agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    _, tp = _params(nscales=1, warps=3, iterations=100, epsilon=0.02)
    for shape in ((3, 70, 150), (2, 34, 60)):
        args = tuple(a.cuda() for a in _level_inputs(rng, *shape))
        step = tcc.level_exit_every(*shape[1:])
        before = tcc.tvl1_chunk_level_solve.launches
        k1, _, kit = tcc.tvl1_chunk_level_solve(*args, tp)
        assert tcc.tvl1_chunk_level_solve.launches == before + 1
        for o1, _, oit in (
                _old_chunk_level_loop(*args, tp, tcc.tvl1_chunk_sweep),
                tcc.tvl1_chunk_level_solve_plain(*args, tp)):
            assert bool(((kit - oit).abs() <= step).all())
            same = kit == oit
            assert bool(same.any())
            assert float((k1[same] - o1[same]).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_chunk_sweep_matches_plain_version_on_the_card(rng):
    """The sweep entry on the GPU against the loop over the plain version:
    counts equal or one chunk apart (the device adds the tile sums in another
    order), state within 1e-4 where they agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    _, tp = _params(nscales=1)
    for (n, h, w), step in (((3, 70, 150), tcc.CHUNK_K), ((2, 34, 60), 1)):
        ro, state = (t.cuda() for t in _sweep_inputs(rng, n, h, w))
        thresh = 0.02 ** 2 * h * w
        ki = torch.zeros(n, dtype=torch.int32, device="cuda")
        pi = torch.zeros_like(ki)
        before = tcc.tvl1_chunk_sweep.launches
        ks, _ = tcc.tvl1_chunk_sweep(ro, state, 100, thresh, tp, iters=ki)
        ps, _ = tcc.tvl1_chunk_sweep_plain(ro, state, 100, thresh, tp,
                                           iters=pi)
        assert tcc.tvl1_chunk_sweep.launches == before + 1
        assert bool(((ki - pi).abs() <= step).all())
        same = ki == pi
        assert bool(same.any())
        assert float((ks[same] - ps[same]).abs().max()) <= 1e-4
