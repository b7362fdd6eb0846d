"""The port's blocked level solve (through its plain version) and the
routing between the two level kernels, against the JAX package's blocked
kernel run in interpret mode and its jnp solver, on the CPU, on the same
numpy inputs."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optflow_tpu.core.config import TVL1Params as JaxParams
from optflow_tpu.ops import tvl1 as jtv
from optflow_tpu.ops import tvl1_pallas as jtp
from optflow_tpu_torch import convert
from optflow_tpu_torch.ops import tvl1 as ttv
from optflow_tpu_torch.ops import tvl1_blocked_cuda as tbc
from optflow_tpu_torch.ops import tvl1_cuda as tc
from tests.conftest import make_fibsem_like
from tests.test_tvl1 import translate

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

K = 8  # iterations per chunk in these tests, on both sides


def _params(**kw):
    jp = JaxParams(**kw)
    return jp, convert.params_from_reference(dataclasses.asdict(jp))


def _pairs(rng, n, h, w, dx=1.2, dy=-0.6):
    i0 = np.stack([make_fibsem_like(rng, h, w) for _ in range(n)])
    i1 = np.stack([translate(a, dx, dy) for a in i0])
    return i0, i1


def _shrink_blocked_geometry(monkeypatch, rows):
    """Force the JAX blocked kernel into several row blocks at a small size,
    as its own test does: the module is patched here, not edited."""
    real = jtp._blocked_geometry

    def small_geo(hh, ww, s, k=8, budget=None):
        return real(hh, ww, s, k, budget=220 * ww * rows)

    monkeypatch.setattr(jtp, "_blocked_geometry", small_geo)
    return small_geo


def test_blocked_plain_matches_tpu_blocked_kernel_in_interpret_mode(
        rng, monkeypatch):
    """(2, 64, 128), 3 warps x up to 100 iterations, epsilon 0.01, k = 8,
    against `_blocked_level_fn` on 8 row blocks. The TPU kernel samples with
    the approximate shift-compose warp and approximate reciprocals, the port
    gathers and divides exactly: mean < 0.01 px, max < 0.1 px. Both count
    whole chunks, and an error that lands on the other side of the threshold
    moves a sweep's exit by one chunk: counts within one chunk per sweep."""
    n, h, w = 2, 64, 128
    i0, i1 = _pairs(rng, n, h, w)
    jp, tp = _params(nscales=1, warps=3, iterations=100, epsilon=0.01)
    geo = _shrink_blocked_geometry(monkeypatch, 40)(h, w, 8)
    assert geo.nb == 8 and geo.halo == 16
    u = jnp.zeros((n, h, w), jnp.float32)
    j1, j2, viol, jit_, _ = jtp._blocked_level_fn(
        n, (h, w), None, jp, True, 8, K
    )(jnp.asarray(i0), jnp.asarray(i1), u, u)
    assert int(np.asarray(viol).max()) == 0  # in-contract flow
    zt = torch.zeros(n, h, w)
    t1, t2, tit = tbc.tvl1_blocked_level_solve(
        torch.from_numpy(i0), torch.from_numpy(i1), zt, zt, tp, k=K
    )
    for got, want in ((t1, j1), (t2, j2)):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.mean() < 0.01
        assert d.max() < 0.1
    jit_ = np.asarray(jit_)
    m_last = 100 - (100 // K) * K
    assert (tit.numpy() < 300).all() and (jit_ < 300).all()  # the exit fired
    for c in tit.tolist() + jit_.tolist():
        # a sum of chunks of K, and per sweep at most one last chunk of m_last
        assert any((c - s * m_last) % K == 0 for s in range(4)), c
    assert np.abs(tit.numpy() - jit_).max() <= 3 * K


def test_blocked_plain_fixed_count_matches_jnp_and_plain_level_solve(rng):
    """epsilon = 0: the exit rule plays no part, so the blocked plain version
    IS the plain level solve (bit for bit), and agrees with the jnp
    tvl1_flow_level within 2e-3 px (same arithmetic, other fusion, 60
    accumulating iterations)."""
    n, h, w = 2, 64, 128
    i0, i1 = _pairs(rng, n, h, w)
    jp, tp = _params(nscales=1, warps=3, iterations=20, epsilon=0.0)
    args = (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.zeros(n, h, w), torch.zeros(n, h, w), tp)
    b1, b2, bit = tbc.tvl1_blocked_level_solve_plain(*args, k=K)
    p1, p2, _, pit = ttv.level_solve_plain(*args)
    assert torch.equal(b1, p1) and torch.equal(b2, p2)
    assert bit.tolist() == pit.tolist() == [60, 60]
    z = jnp.zeros((h, w), jnp.float32)
    for k in range(n):
        a1, a2, _ = jtv.tvl1_flow_level(
            jnp.asarray(i0[k]), jnp.asarray(i1[k]), z, z, jp)
        assert np.abs(b1[k].numpy() - np.asarray(a1)).max() <= 2e-3
        assert np.abs(b2[k].numpy() - np.asarray(a2)).max() <= 2e-3
    assert float(b1.abs().max()) > 0.5


def test_blocked_exit_rule_on_whole_images(rng):
    """The rule of the kernel: tested after every k-th iteration of a sweep
    on that iteration's error, per image, never before a sweep's first chunk
    has run. So every sweep runs at least k, counts are whole chunks, an
    image never stops before the exact per-iteration rule would, and at most
    k - 1 iterations a sweep after it."""
    n, h, w = 3, 48, 96
    i0 = np.stack([make_fibsem_like(rng, h, w)] * n)
    i1 = np.stack([translate(i0[0], 0.2, 0.0), translate(i0[0], 1.0, -0.5),
                   translate(i0[0], 2.0, 1.0)])
    _, tp = _params(nscales=1, warps=3, iterations=100, epsilon=0.02)
    args = (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.zeros(n, h, w), torch.zeros(n, h, w), tp)
    _, _, bit = tbc.tvl1_blocked_level_solve_plain(*args, k=K)
    _, _, _, exact = ttv.level_solve_plain(*args)
    m_last = 100 % K
    for b, e in zip(bit.tolist(), exact.tolist()):
        assert 3 * K <= b < 300
        assert any((b - s * m_last) % K == 0 for s in range(4))
        assert e <= b <= e + 3 * (K - 1)
    assert len(set(bit.tolist())) > 1  # each image on its own
    # the default k is the JAX package's
    assert tbc.BLOCKED_K == jtp._BLOCKED_K == 16
    with pytest.raises(ValueError, match="k must be"):
        tbc.tvl1_blocked_level_solve(*args, k=17)
    with pytest.raises(ValueError, match="gamma"):
        tbc.tvl1_blocked_level_solve(
            *args[:4], dataclasses.replace(tp, gamma=0.5))


def test_routing_budget_is_the_jax_packages():
    """The same levels take the counterpart kernels in both packages."""
    assert tc.FUSED_PX_BUDGET == jtp._fused_px_budget(8)
    for shape in ((256, 1024), (410, 819), (512, 1024), (524, 524),
                  (655, 655), (1024, 1024), (34, 137)):
        fits = (jtp._round_up(shape[0], 8) * jtp._round_up(shape[1], 128)
                <= jtp._fused_px_budget(8))
        assert tc.takes_blocked_kernel(*shape) == (not fits), shape
    assert not tc.takes_blocked_kernel(256, 1024)  # no level of a strip
    assert tc.takes_blocked_kernel(512, 1024)  # a section's finest level


def test_routing_sends_large_levels_to_the_blocked_solver(rng, monkeypatch):
    """With the budget shrunk, a 3-scale pyramid at (2, 48, 128) runs its
    finest level through the blocked solver and the others through the level
    solver (their plain versions, on the CPU). Against the unshrunk solve:
    < 0.05 px, as the JAX package's own routing test allows (the blocked
    level runs up to k - 1 more iterations per sweep). Against the JAX
    package's tvl1_flow_batched_pallas in interpret mode under the same
    shrink: < 0.05 px too, and both within 0.5 px of the truth.

    epsilon is 0.004 here: where an image stops decides the flow to about
    ten times epsilon, and at the default 0.01 the two exit rules end
    0.1 px apart at the worst pixel (0.01 px in the mean)."""
    n, h, w = 2, 48, 128
    i0, i1 = _pairs(rng, n, h, w, 1.0, 0.5)
    jp, tp = _params(nscales=3, warps=3, iterations=100, epsilon=0.004)
    t0, t1 = torch.from_numpy(i0), torch.from_numpy(i1)

    calls = {"blocked": [], "level": []}
    real_blocked, real_level = tbc.tvl1_blocked_level_solve, tc.tvl1_level_solve

    def spy_blocked(a, *rest, **kw):
        calls["blocked"].append(tuple(a.shape[1:]))
        return real_blocked(a, *rest, **kw)

    def spy_level(a, *rest, **kw):
        calls["level"].append(tuple(a.shape[1:]))
        return real_level(a, *rest, **kw)

    monkeypatch.setattr(tbc, "tvl1_blocked_level_solve", spy_blocked)
    monkeypatch.setattr(tc, "tvl1_level_solve", spy_level)

    ref = tc.tvl1_flow_batched_cuda(t0, t1, tp).numpy()
    assert calls == {"blocked": [], "level": [(30, 82), (38, 102), (48, 128)]}

    monkeypatch.setattr(tc, "FUSED_PX_BUDGET", 40 * 128)
    calls["level"].clear()
    mixed = tc.tvl1_flow_batched_cuda(t0, t1, tp).numpy()
    assert calls == {"blocked": [(48, 128)], "level": [(30, 82), (38, 102)]}
    assert np.abs(mixed - ref).max() < 0.05
    stats = ttv.get_last_iteration_stats()
    assert [s for s, _ in stats] == [(30, 82), (38, 102), (48, 128)]
    assert all(it.shape == (n,) and int(it.min()) > 0 for _, it in stats)
    # the blocked level's counts are whole chunks of the default k
    assert all(any((c - s * (100 % tbc.BLOCKED_K)) % tbc.BLOCKED_K == 0
                   for s in range(4))
               for c in stats[-1][1].tolist())

    monkeypatch.setattr(jtp, "_FUSED_PX_BUDGET", 40 * 128)
    monkeypatch.setattr(jtp, "_on_tpu", lambda: True)
    want = np.asarray(jtp.tvl1_flow_batched_pallas(
        jnp.asarray(i0), jnp.asarray(i1), jp, interpret=True))
    assert np.abs(mixed - want).max() < 0.05
    for flow in (mixed, want):
        assert np.hypot(flow[..., 0] - 1.0, flow[..., 1] - 0.5).mean() <= 0.5


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch(rng):
    from optflow_tpu_torch.ops.tvl1_chunk_cuda import tvl1_chunk

    n, h, w = 1, 40, 72
    i0, i1 = _pairs(rng, n, h, w)
    _, tp = _params(nscales=1, warps=1, iterations=K)
    args = (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.zeros(n, h, w), torch.zeros(n, h, w), tp)
    before = (tbc.tvl1_blocked_level_solve.launches, tvl1_chunk.launches)
    a = tbc.tvl1_blocked_level_solve(*args)
    b = tbc.tvl1_blocked_level_solve_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    state = torch.zeros(n, 6, h, w)
    tvl1_chunk(torch.zeros(n, 3, h, w), state, 1, -1.0, tp)
    assert (tbc.tvl1_blocked_level_solve.launches, tvl1_chunk.launches) \
        == before == (0, 0)


@pytest.mark.gpu
def test_blocked_kernel_matches_plain_version_and_level_kernel_on_the_card(rng):
    """The CUDA kernel against its plain version and against the level
    kernel, on the GPU (1e-3 px at a fixed 2 x 20 iterations, k = 8, a size
    of 3 x 3 tiles). `python3 chip_smoke.py` runs the same comparison at the
    product's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    n, h, w = 2, 70, 150
    i0, i1 = _pairs(rng, n, h, w)
    _, tp = _params(nscales=1, warps=2, iterations=20, epsilon=0.0)
    args = (torch.from_numpy(i0).cuda(), torch.from_numpy(i1).cuda(),
            torch.zeros(n, h, w).cuda(), torch.zeros(n, h, w).cuda(), tp)
    before = tbc.tvl1_blocked_level_solve.launches
    k1, k2, kit = tbc.tvl1_blocked_level_solve(*args, k=K)
    assert tbc.tvl1_blocked_level_solve.launches == before + 1
    p1, p2, pit = tbc.tvl1_blocked_level_solve_plain(*args, k=K)
    a1, a2, ait = tc.tvl1_level_solve(*args)
    for x, y in ((k1, p1), (k2, p2), (k1, a1), (k2, a2)):
        assert float((x - y).abs().max()) <= 1e-3
    assert torch.equal(kit, pit) and torch.equal(kit, ait)
