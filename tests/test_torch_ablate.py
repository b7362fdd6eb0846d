"""The port's two tooling kernels through their plain versions, on the CPU:
the iteration-ablation kernel against the JAX tool's own kernel body run in
interpret mode on the same numpy inputs, and the shared-memory capacity
probe. The CUDA kernels themselves run only on a card (marked ``gpu``)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ablate_sweep
import compare_trees
import tools_kernel_ablate as jax_tool
from optflow_tpu.ops.tvl1_pallas import _select_geometry
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops import smem_cap_cuda as probe
from optflow_tpu_torch.ops import tvl1_ablate_cuda as tab
from optflow_tpu_torch.ops.tvl1_chunk_cuda import (
    ONE_BLOCK_MAX_PX,
    tvl1_chunk_plain,
)
from optflow_tpu_torch.tools import kernel_ablate, smem_cap

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

N, H, W = 2, 20, 150  # one block of the JAX tool's geometry: 24 x 256 canvas


def _inputs(geo):
    rng = np.random.default_rng(0)
    ro = rng.standard_normal((N, 3, geo.hp, geo.wp)).astype(np.float32)
    state = (rng.standard_normal((N, 6, geo.hp, geo.wp)) * 0.1).astype(
        np.float32)
    return ro, state


def _jax_kernel(geo, ro, state, m, **flags):
    """The JAX tool's kernel body in interpret mode: its ``run`` has no
    interpret switch, so the same pallas_call is built here around
    ``make_kernel``."""
    hbm = pl.BlockSpec(memory_space=pltpu.MemorySpace.HBM)
    out, errs = pl.pallas_call(
        jax_tool.make_kernel(geo, **flags),
        grid=(N,),
        out_shape=(
            jax.ShapeDtypeStruct(state.shape, jnp.float32),
            jax.ShapeDtypeStruct((N, 1), jnp.float32),
        ),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), hbm, hbm],
        out_specs=(hbm, pl.BlockSpec(memory_space=pltpu.SMEM)),
        scratch_shapes=[
            pltpu.VMEM((3, geo.win, geo.wp), jnp.float32),
            pltpu.VMEM((6, geo.win, geo.wp), jnp.float32),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.SemaphoreType.DMA(()),
        ],
        interpret=True,
    )(jnp.asarray([m, H, W], jnp.int32), jnp.asarray(ro), jnp.asarray(state))
    return np.asarray(out), np.asarray(errs)


@pytest.mark.parametrize("name", list(tab.VARIANTS))
def test_plain_version_equals_the_jax_tools_kernel_body(name):
    """Every variant, same inputs, 5 fixed iterations (2 without the
    divisions, whose values then reach 1e4): state within 1e-5 on the real
    h x w, relative to the largest value where that exceeds 1; error sums
    within 1e-5 relative."""
    geo = _select_geometry(H, W)
    assert geo.nb == 1
    flags = tab.VARIANTS[name]
    m = 5 if flags["div"] else 2
    ro, state = _inputs(geo)
    want, want_e = _jax_kernel(geo, ro, state, m, **flags)
    got, got_e = tab.tvl1_ablate_plain(
        torch.from_numpy(ro), torch.from_numpy(state), m, H, W, **flags)
    want = want[:, :, :H, :W]
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(want).all()
    assert np.abs(got.numpy()[:, :, :H, :W] - want).max() / scale <= 1e-5
    assert got_e.shape == (N, 1)
    assert np.abs(got_e.numpy() - want_e).max() <= 1e-5 * np.abs(want_e).max()
    assert np.abs(got.numpy()[:, :2, :H, :W] - state[:, :2, :H, :W]).max() > 1e-3


def test_variant_names_and_switches_are_the_jax_tools():
    src = inspect.getsource(jax_tool.main)
    at = -1
    for name, f in tab.VARIANTS.items():
        line = (f'("{name}", dict(err={f["err"]}, sqrt={f["sqrt"]}, '
                f'div={f["div"]}, roll={f["roll"]}))')
        assert line in src
        assert src.index(line) > at  # the same order, so outputs line up
        at = src.index(line)
    assert (tab.L_T, tab.THETA, tab.TAUT) == (
        jax_tool.L_T, jax_tool.THETA, jax_tool.TAUT)
    assert (kernel_ablate.main.__module__.endswith("kernel_ablate")
            and inspect.signature(kernel_ablate.run_ablation).parameters[
                "device"].default == "cuda")


def test_full_is_the_chunk_kernels_iteration_with_the_exit_disabled():
    """The plain `full` variant and the plain chunk kernel (thresh < 0 never
    stops) run the same arithmetic: not one bit apart, errors included."""
    ro, state = kernel_ablate.make_inputs(2, 40, 70, "cpu")
    want = state
    for m in (8, 8, 3):
        want, want_e = tvl1_chunk_plain(ro, want, m, -1.0, TVL1Params())
    got, got_e = tab.tvl1_ablate_chunks(ro, state, 19, 40, 70)
    assert torch.equal(got, want)
    assert torch.allclose(got_e[:, 0], want_e.sum(1), rtol=1e-6)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_no_launch():
    ro, state = kernel_ablate.make_inputs(2, 24, 40, "cpu")
    before = tab.tvl1_ablate_chunks.launches
    for flags in tab.VARIANTS.values():
        a = tab.tvl1_ablate_chunks(ro, state, 3, 24, 40, **flags)
        b = tab.tvl1_ablate_plain(ro, state, 3, 24, 40, **flags)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        if not flags["err"]:
            assert a[1].tolist() == [[1.0], [1.0]]
    assert tab.tvl1_ablate_chunks.launches == before == 0


def test_iteration_count_is_fixed_whatever_the_error():
    """m iterations are m applications of one: the loop never stops early,
    not even on a state that no longer moves."""
    ro, state = kernel_ablate.make_inputs(1, 24, 40, "cpu")
    ro = torch.zeros_like(ro)  # no data term: the flow converges at once
    step = state
    for _ in range(6):
        step, _ = tab.tvl1_ablate_plain(ro, step, 1, 24, 40)
    whole, errs = tab.tvl1_ablate_plain(ro, state, 6, 24, 40)
    assert torch.equal(whole, step) and errs.shape == (1, 1)


def test_padding_outside_the_real_size_is_returned_unchanged():
    ro, state = kernel_ablate.make_inputs(2, 32, 64, "cpu")
    out, _ = tab.tvl1_ablate_chunks(ro, state, 4, 20, 50)
    inner, _ = tab.tvl1_ablate_chunks(
        ro[:, :, :20, :50].contiguous(), state[:, :, :20, :50].contiguous(),
        4, 20, 50)
    assert torch.equal(out[:, :, :20, :50], inner)
    assert torch.equal(out[:, :, 20:], state[:, :, 20:])
    assert torch.equal(out[:, :, :, 50:], state[:, :, :, 50:])


@pytest.mark.parametrize("m,launches", [(1, 1), (8, 2), (9, 3), (50, 13),
                                        (600, 150)])
def test_launches_per_call(m, launches):
    """Four iterations a launch (the halo), the last launch what is left;
    no separate launch for the errors."""
    assert tab.launches_per_call(m) == launches
    assert len(tab.launch_iterations(m)) == launches
    assert sum(tab.launch_iterations(m)) == m
    assert max(tab.launch_iterations(m)) <= tab.ABLATE_K


# shapes with several tiles both ways (tiles of 88 x 24), ragged last tiles,
# one tile, and an image narrower than the halo; counts with and without a
# short last launch
@pytest.mark.parametrize("n,h,w,m", [(2, 200, 70, 9), (1, 40, 30, 4),
                                     (2, 96, 50, 1), (1, 177, 49, 13),
                                     (1, 12, 6, 6)])
@pytest.mark.parametrize("name", list(tab.VARIANTS))
def test_schedule_emulation_equals_the_plain_version(n, h, w, m, name):
    """The kernel's schedule (launches of at most K iterations, each tile
    iterated on its window of K more pixels a side and only its tile kept)
    is the plain iteration of the whole image, bit for bit; the errors,
    added tile by tile, within float32 rounding."""
    flags = tab.VARIANTS[name]
    m = m if flags["div"] else min(m, 2)
    ro, state = kernel_ablate.make_inputs(n, h, w, "cpu")
    got, got_e = tab.tvl1_ablate_schedule_plain(ro, state, m, h, w, **flags)
    want, want_e = tab.tvl1_ablate_plain(ro, state, m, h, w, **flags)
    assert torch.equal(got, want)
    assert got_e.shape == want_e.shape == (n, 1)
    assert torch.allclose(got_e, want_e, rtol=1e-5, atol=0.0)


def test_tiles_cover_the_image_once_in_row_major_order():
    h, w = 200, 70
    seen = torch.zeros(h, w, dtype=torch.int32)
    tiles = list(tab.tiles(h, w))
    assert len(tiles) == -(-h // tab.TILE_H) * -(-w // tab.TILE_W) == 9
    assert tiles == sorted(tiles)
    for y0, y1, x0, x1 in tiles:
        assert 0 < y1 - y0 <= tab.TILE_H and 0 < x1 - x0 <= tab.TILE_W
        seen[y0:y1, x0:x1] += 1
    assert bool((seen == 1).all())
    # a block's window is 32 columns (one a lane) by 96 rows (24 warps of 4)
    assert (tab.TILE_W + 2 * tab.ABLATE_K, tab.TILE_H + 2 * tab.ABLATE_K) == (
        32, 96)


@pytest.mark.parametrize("fault,exc", [
    ("dtype", TypeError), ("ro_shape", ValueError), ("m", ValueError),
    ("size", ValueError), ("variant", ValueError), ("strided", ValueError),
])
def test_ablation_wrapper_rejects_what_the_kernel_does_not_take(fault, exc):
    ro, state = kernel_ablate.make_inputs(2, 24, 40, "cpu")
    m, h, w, flags = 3, 24, 40, {}
    if fault == "dtype":
        state = state.double()
    elif fault == "ro_shape":
        ro = ro[:, :2]
    elif fault == "m":
        m = 0
    elif fault == "size":
        h = 25
    elif fault == "variant":
        flags = dict(err=False, roll=False)  # none of the six
    elif fault == "strided":
        state = state.transpose(2, 3)
    with pytest.raises(exc):
        tab.tvl1_ablate_chunks(ro, state, m, h, w, **flags)


def test_ablation_tool_runs_on_the_cpu(capsys):
    rows = kernel_ablate.run_ablation(2, 24, 40, lo=2, hi=5, device="cpu")
    assert [r["name"] for r in rows] == list(tab.VARIANTS)
    # the launches a call of 2 and of 5 iterations makes on a card
    assert all(r["launches_lo"] == 1 and r["launches_hi"] == 2 for r in rows)
    assert all(np.isfinite(r["slope_us_per_iter"]) for r in rows)
    assert kernel_ablate.main(["--n", "1", "--h", "16", "--w", "24", "--lo",
                               "1", "--hi", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "min_body" in out and "us/iter" in out and "launches 1/1" in out
    with pytest.raises(ValueError):
        kernel_ablate.run_ablation(1, 16, 24, lo=5, hi=5, device="cpu")


def test_sweep_patches_the_geometry_and_its_mirror(tmp_path):
    """Patched to the built geometry the copy is unchanged (the patterns and
    the shared-memory formula are the source's); patched to another it
    carries the other one in both the source and the wrapper."""
    import shutil

    pkg = ablate_sweep.ROOT / "optflow_tpu_torch"
    files = ("csrc/tvl1_ablate.cu", "ops/tvl1_ablate_cuda.py")
    shutil.copytree(pkg, tmp_path / "optflow_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    assert ablate_sweep.parse("4,24,4") == (4, 24, tab.ABLATE_K, False)
    ablate_sweep.patch(tmp_path, 4, 24, tab.ABLATE_K, False)
    for f in files:
        assert (tmp_path / "optflow_tpu_torch" / f).read_text() == (
            pkg / f).read_text()
    ablate_sweep.patch(tmp_path, 3, 32, 6, True)
    cu = (tmp_path / "optflow_tpu_torch" / files[0]).read_text()
    assert "constexpr int RUN = 3;" in cu and "constexpr int WARPS = 32;" in cu
    assert "constexpr int ABLATE_K = 6;" in cu
    assert "const bool vec = false && " in cu
    py = (tmp_path / "optflow_tpu_torch" / files[1]).read_text()
    assert "TILE_H, TILE_W = 84, 20" in py and "\nABLATE_K = 6\n" in py
    for bad in ("4,24", "4,24,4,fast"):
        with pytest.raises(ValueError):
            ablate_sweep.parse(bad)


def test_compare_trees_pairs_the_runs_in_turns(tmp_path):
    """Runs other, this, this, other: each tree's mean is of its own two."""
    runs = [{"kernels": {"a": {"ms": v, "call_ms": 2 * v}},
             "ablate": {"slope_us_per_iter": {"full": 10 * v}}}
            for v in (4.0, 1.0, 3.0, 6.0)]
    got = compare_trees.in_turns(runs)
    assert got["kernels"]["a"]["ms"] == {"runs": [4.0, 1.0, 3.0, 6.0],
                                         "other": 5.0, "this": 2.0}
    assert got["kernels"]["a"]["this_call_ms"] == [2.0, 6.0]
    assert got["ablate_slope_us_per_iter"]["full"]["other"] == 50.0
    with pytest.raises(SystemExit):
        compare_trees.main([str(tmp_path)])  # no chip_smoke.py there


# --- the shared-memory capacity probe ---------------------------------------


@pytest.mark.parametrize("n_bytes", [16 * 1024, 227 * 1024, 232448])
def test_probe_plain_version_returns_the_fill_value(n_bytes):
    status, means = probe.smem_fill_mean_plain(n_bytes, 3.0)
    assert status.ok and tuple(status) == (0, 0, 0)
    assert means.shape == (1,) and abs(float(means[0]) - 3.0) <= 1e-6


def test_probe_wrapper_on_cpu_takes_the_plain_version():
    before = probe.smem_fill_mean.launches
    x = torch.tensor([2.75])
    status, means = probe.smem_fill_mean(4096, x, blocks=3)
    assert status.ok and means.tolist() == [2.75] * 3
    status, means = probe.smem_fill_mean(4096, 0.5, device="cpu")
    assert status.ok and means.tolist() == [0.5]
    assert probe.smem_fill_mean.launches == before == 0
    for bad in (dict(n_bytes=130), dict(n_bytes=64), dict(blocks=0)):
        with pytest.raises(ValueError):
            probe.smem_fill_mean(**{"n_bytes": 4096, "x": x, **bad})
    assert probe.error_string(0) == "no error"
    assert probe.error_string(-1) == "not reached"


def test_probe_tool_on_the_cpu_and_the_ports_constants(capsys):
    """On the CPU nothing is refused; the table still carries the two
    constants the kernels rest on, which must fit a block's 227 KB."""
    table = smem_cap.run_probe("cpu")
    assert [r["kib"] for r in table["sizes"]] == list(smem_cap.SIZES_KIB)
    assert all(r["ok"] for r in table["sizes"]) and table["attrs"] is None
    assert table["blocked_window_bytes"] == 9 * 64 * 96 * 4 == 221184
    assert table["chunk_one_block_bytes"] == ONE_BLOCK_MAX_PX * 36
    assert ONE_BLOCK_MAX_PX == 6449
    assert max(table["blocked_window_bytes"],
               table["chunk_one_block_bytes"]) <= 232448
    assert smem_cap.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "shared  227 KiB: OK" in out and "fits" in out


def test_probe_tool_checks_the_grid_and_ablation_windows(capsys):
    """The level grid's window, from the grid's tile and halo (the level
    wrapper's mirror of csrc/tvl1_grid.cuh on the CPU), and the ablation
    kernel's block are in the table; the block's size comes only from its
    library, so on the CPU it is not known."""
    from optflow_tpu_torch.ops import tvl1_cuda

    table = smem_cap.run_probe("cpu")
    grid = 9 * (tvl1_cuda.LEVEL_TILE_H + 2 * tvl1_cuda.LEVEL_HALO) * (
        tvl1_cuda.LEVEL_TILE_W + 2 * tvl1_cuda.LEVEL_HALO) * 4
    assert table["grid_window_bytes"] == grid == 103680
    assert table["ablate_block_bytes"] is None
    assert table["ablate_block_fits"] is None
    assert set(smem_cap.CONSTANTS) == {
        "blocked_window", "chunk_one_block", "grid_window", "ablate_block"}
    assert all(table[k + "_fits"] for k in smem_cap.CONSTANTS
               if k != "ablate_block")
    assert smem_cap.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "level grid's window: 103680 B fits" in out
    assert "ablation kernel's block: known from its library on a card" in out


# --- on a card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
# 200 columns take the kernel's 16-byte window copies, 198 (not a multiple
# of 4) the 4-byte ones
@pytest.mark.parametrize("w", [200, 198])
def test_ablation_kernel_against_its_plain_version_on_the_card(cuda, w):
    ro, state = kernel_ablate.make_inputs(2, 96, w, cuda)
    for name, flags in tab.VARIANTS.items():
        m = 19 if flags["div"] else 2
        ks, ke = tab.tvl1_ablate_chunks(ro, state, m, 96, w, **flags)
        ps, pe = tab.tvl1_ablate_plain(ro, state, m, 96, w, **flags)
        scale = max(1.0, float(ps.abs().max()))
        assert float((ks - ps).abs().max()) / scale <= 1e-4, name
        assert torch.allclose(ke, pe, rtol=1e-3), name


@pytest.mark.gpu
@pytest.mark.parametrize("m", [16, 50])
# 1024 columns take the 16-byte window copies, 198 (not a multiple of 4)
# the 4-byte ones
@pytest.mark.parametrize("n,h,w", [(3, 256, 1024), (2, 96, 198)])
def test_full_equals_the_chunk_kernel_bit_for_bit_on_the_card(cuda, m, n, h,
                                                              w):
    """`full` against tvl1_chunk with the exit disabled, chunks of 8 (m = 50
    ends on 2): the same per-pixel arithmetic in another schedule, not one
    bit apart; the error sums within 1e-5 relative; a rerun the same bits."""
    from optflow_tpu_torch.ops.tvl1_chunk_cuda import CHUNK_K, tvl1_chunk

    ro, state = kernel_ablate.make_inputs(n, h, w, cuda)
    got, got_e = tab.tvl1_ablate_chunks(ro, state, m, h, w)
    want = state
    for k in (CHUNK_K,) * (m // CHUNK_K) + (m % CHUNK_K,) * (m % CHUNK_K > 0):
        want, want_e = tvl1_chunk(ro, want, k, -1.0, TVL1Params(nscales=1))
    assert torch.equal(got, want)
    assert torch.allclose(got_e[:, 0], want_e.sum(1), rtol=1e-5, atol=0.0)
    again, again_e = tab.tvl1_ablate_chunks(ro, state, m, h, w)
    assert torch.equal(again, got) and torch.equal(again_e, got_e)


@pytest.mark.gpu
def test_probe_kernel_time_is_within_the_call(cuda):
    """The kernel's time by the events around its launch is positive and no
    longer than the whole call by the host clock."""
    import time

    attrs = probe.device_shared_memory(cuda)
    x = torch.full((1,), 3.0, device=cuda)
    probe.smem_fill_mean(attrs.optin_per_block, x)  # warm
    t0 = time.perf_counter()
    status, _ = probe.smem_fill_mean(attrs.optin_per_block, x)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert status.ok
    assert 0.0 < probe.last_kernel_ms() <= wall_ms


@pytest.mark.gpu
def test_probe_kernel_finds_the_cards_limit(cuda):
    attrs = probe.device_shared_memory(cuda)
    status, means = probe.smem_fill_mean(attrs.optin_per_block, 3.0)
    assert status.ok and abs(float(means[0]) - 3.0) <= 1e-6
    status, means = probe.smem_fill_mean(attrs.optin_per_block + 1024, 3.0)
    assert not status.ok and means is None
