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


@pytest.mark.parametrize("m,launches", [(1, 1), (8, 1), (9, 2), (50, 7),
                                        (600, 75)])
def test_launches_per_call(m, launches):
    assert tab.launches_per_call(m) == launches


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
    assert all(r["launches_lo"] == 1 and r["launches_hi"] == 1 for r in rows)
    assert all(np.isfinite(r["slope_us_per_iter"]) for r in rows)
    assert kernel_ablate.main(["--n", "1", "--h", "16", "--w", "24", "--lo",
                               "1", "--hi", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "min_body" in out and "us/iter" in out and "launches 1/1" in out
    with pytest.raises(ValueError):
        kernel_ablate.run_ablation(1, 16, 24, lo=5, hi=5, device="cpu")


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


# --- on a card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ablation_kernel_against_its_plain_version_on_the_card(cuda):
    ro, state = kernel_ablate.make_inputs(2, 96, 200, cuda)
    for name, flags in tab.VARIANTS.items():
        m = 19 if flags["div"] else 2
        ks, ke = tab.tvl1_ablate_chunks(ro, state, m, 96, 200, **flags)
        ps, pe = tab.tvl1_ablate_plain(ro, state, m, 96, 200, **flags)
        scale = max(1.0, float(ps.abs().max()))
        assert float((ks - ps).abs().max()) / scale <= 1e-4, name
        assert torch.allclose(ke, pe, rtol=1e-3), name


@pytest.mark.gpu
def test_probe_kernel_finds_the_cards_limit(cuda):
    attrs = probe.device_shared_memory(cuda)
    status, means = probe.smem_fill_mean(attrs.optin_per_block, 3.0)
    assert status.ok and abs(float(means[0]) - 3.0) <= 1e-6
    status, means = probe.smem_fill_mean(attrs.optin_per_block + 1024, 3.0)
    assert not status.ok and means is None
