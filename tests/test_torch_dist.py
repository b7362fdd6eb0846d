"""The port's distribution against the JAX package's, on the CPU: the mesh,
the pair scheduler, the row-tiled halo solve, the multi-device batch runner
and the sharded alignment solves. The JAX functions run on the conftest's
8-device virtual CPU mesh, the port's on meshes of repeated CPU devices
(``[torch.device("cpu")] * n``), on the same seeded numpy inputs;
tolerances are stated per test. Also the thread safety of the kernel
wrappers that the one-thread-per-device dispatch relies on."""

import sys
import threading
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from optflow_tpu.align import distributed as jdist
from optflow_tpu.align import global_solve as jgs
from optflow_tpu.align import zblock as jzb
from optflow_tpu.core.config import TVL1Params as JaxParams
from optflow_tpu.dist import tiled as jtiled
from optflow_tpu.dist.mesh import make_pair_mesh as jax_mesh
from optflow_tpu.dist.scheduler import PairScheduler as JaxScheduler
from optflow_tpu.engine import batch_runner as jbr
from optflow_tpu_torch.align import distributed as tdist
from optflow_tpu_torch.align import global_solve as tgs
from optflow_tpu_torch.align import zblock as tzb
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.dist import mesh as tmesh
from optflow_tpu_torch.dist import tiled as ttiled
from optflow_tpu_torch.dist.scheduler import PairScheduler
from optflow_tpu_torch.engine import batch_runner as tbr
from optflow_tpu_torch.ops import _build
from optflow_tpu_torch.ops import tvl1 as ttv
import chip_smoke
from tests.conftest import make_fibsem_like
from tests.test_align import _make_affine_matches, _make_matches, _small_affines
from tests.test_tvl1 import mean_epe, translate

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

CPU = torch.device("cpu")
FAST = dict(nscales=3, warps=2, iterations=40)
TILED = dict(nscales=2, warps=2, iterations=40)


def cpu_mesh(n_pairs_axis=None, n_rows_axis=1, n=8):
    return tmesh.make_pair_mesh(n_pairs_axis, n_rows_axis, devices=[CPU] * n)


def both_params(**kw):
    return JaxParams(**kw), TVL1Params(**kw)


def jax_tiled(im0, im1, params, mesh, **kw):
    return np.asarray(jtiled.tiled_tvl1_flow(
        jnp.asarray(im0), jnp.asarray(im1), params, mesh, **kw))


def port_tiled(im0, im1, params, mesh, **kw):
    return ttiled.tiled_tvl1_flow(im0, im1, params, mesh, **kw).numpy()


# --- the mesh ---------------------------------------------------------------


def test_mesh_shapes_equal_the_jax_package():
    for args in ((None, 1), (4, 2), (2, 4), (1, 8), (3, 2)):
        want = jax_mesh(*args)
        got = cpu_mesh(*args)
        assert got.shape == dict(want.shape)
        assert got.devices.shape == want.devices.shape
    mesh = cpu_mesh(4, 2)
    assert tmesh.pairs_axis_devices(mesh) == [CPU] * 4
    assert tmesh.rows_axis_devices(mesh) == [CPU] * 2
    with pytest.raises(ValueError, match="needs more than"):
        cpu_mesh(4, 4)


def test_default_mesh_is_the_visible_cards_and_never_the_cpu():
    if torch.cuda.is_available():
        mesh = tmesh.make_pair_mesh()
        assert mesh.shape["pairs"] == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.devices.flat)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_pair_mesh()


def test_initialize_multihost_without_arguments_is_a_no_op():
    tmesh.initialize_multihost()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        tmesh.initialize_multihost("127.0.0.1:1", 2)


def test_a_worker_s_exception_re_raises_in_the_caller():
    def solve(dev, k):
        if k == 2:
            raise RuntimeError("launch failed on shard 2")
        return k

    with pytest.raises(RuntimeError, match="shard 2"):
        tmesh.on_devices(solve, [CPU] * 4, range(4))
    assert tmesh.on_devices(lambda dev, k: k * k, [CPU] * 3, range(3)) \
        == [0, 1, 4]


# --- the pair scheduler -------------------------------------------------------


def test_scheduler_pads_and_equals_the_jax_package(rng):
    """5 pairs over 8 pairs devices (3 zero pairs of padding): flows within
    1e-3 px of the JAX scheduler's, EPE < 0.4 px as the JAX test gates."""
    jp, tp = both_params(**FAST)
    pairs, gts = [], []
    for k in range(5):
        im0 = make_fibsem_like(rng, 48, 64)
        dx, dy = 1.0 + 0.2 * k, -0.5
        pairs.append((im0, translate(im0, dx, dy)))
        gts.append((dx, dy))
    want = JaxScheduler(jax_mesh(), jp).solve_pairs(pairs)
    got = PairScheduler(cpu_mesh(), tp).solve_pairs(pairs)
    assert len(got) == 5
    for g, w, (dx, dy) in zip(got, want, gts):
        assert g.shape == (48, 64, 2) and g.dtype == np.float32
        assert np.abs(g - np.asarray(w)).max() <= 1e-3
        assert mean_epe(g, dx, dy) < 0.4


def test_scheduler_mixed_shapes_equal_the_jax_package(rng):
    jp, tp = both_params(**FAST)
    a = make_fibsem_like(rng, 48, 64)
    b = make_fibsem_like(rng, 32, 48)
    pairs = [(a, translate(a, 1, 0)), (b, translate(b, 0, 1)),
             (a, translate(a, 1, 0))]
    want = JaxScheduler(jax_mesh(), jp).solve_pairs(pairs)
    got = PairScheduler(cpu_mesh(), tp).solve_pairs(pairs)
    assert [g.shape for g in got] == [(48, 64, 2), (32, 48, 2), (48, 64, 2)]
    for g, w in zip(got, want):
        assert np.abs(g - np.asarray(w)).max() <= 1e-3
    assert mean_epe(got[1], 0, 1) < 0.4
    # the chunk sizes follow the JAX rule
    sched = PairScheduler(cpu_mesh(), tp)
    jsched = JaxScheduler(jax_mesh(), jp)
    for shape in ((48, 64), (256, 1024), (4096, 4096)):
        assert sched._chunk_pairs(shape) == jsched._chunk_pairs(shape)


def test_scheduler_chunks_equal_one_dispatch(rng, monkeypatch):
    """Chunks of 2 pairs on a pairs axis of 2 (three chunks of one shape,
    all enqueued before any is read back) give the flows of one dispatch
    of the whole list, bit for bit."""
    tp = TVL1Params(**FAST)
    pairs = []
    for k in range(5):
        im0 = make_fibsem_like(rng, 32, 48)
        pairs.append((im0, translate(im0, 0.5 * k, 0.25)))
    want = PairScheduler(cpu_mesh(2, n=2), tp).solve_pairs(pairs)
    sched = PairScheduler(cpu_mesh(2, n=2), tp)
    dispatched = []
    dispatch = sched._dispatch
    monkeypatch.setattr(sched, "_chunk_pairs", lambda shape: 2)
    monkeypatch.setattr(sched, "_dispatch", lambda a, b: dispatched.append(
        a.shape[0]) or dispatch(a, b))
    got = sched.solve_pairs(pairs)
    assert dispatched == [2, 2, 2]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_concurrent_check_counts_refusals_and_differences(monkeypatch):
    """chip_smoke.py's check of threads solving distinct shapes at once, on
    [cpu] * 2 at tiny heights: clean solves give no refusal and no
    difference; once the solves made alone are done, a solve that raises is
    counted as refused and a flow that moved as differing, each round."""
    from optflow_tpu_torch.ops import tvl1_cuda

    monkeypatch.setattr(chip_smoke, "DIST_CONCURRENT_HEIGHTS", (16, 24, 40))
    monkeypatch.setattr(chip_smoke, "DIST_CONCURRENT_ROUNDS", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    clean = chip_smoke.dist_concurrent([CPU] * 2)
    assert (clean["refused"], clean["flows_differing"]) == (0, 0)
    assert clean["devices"] == ["cpu"] * 3

    real, calls = tvl1_cuda.tvl1_flow_batched_cuda, []

    def faulty(a, b, params):
        calls.append(a.shape[-2])
        if len(calls) > 3 and a.shape[-2] == 24:
            raise RuntimeError("tvl1_level_solve: CUDA error 701")
        flow = real(a, b, params)
        return flow + 1 if len(calls) > 3 and a.shape[-2] == 40 else flow

    monkeypatch.setattr(tvl1_cuda, "tvl1_flow_batched_cuda", faulty)
    got = chip_smoke.dist_concurrent([CPU] * 2)
    assert (got["refused"], got["flows_differing"]) == (2, 2)
    assert got["first_refusal"] == "tvl1_level_solve: CUDA error 701"


def test_on_shares_splits_a_batch_over_the_devices():
    """Equal contiguous shares, the last devices left out of a small batch,
    ``None`` passed through."""
    x = torch.arange(10.0)
    got = tmesh.on_shares(lambda dev, a, b: (a.tolist(), b), [CPU] * 4,
                          x, None)
    assert got == [([0.0, 1.0, 2.0], None), ([3.0, 4.0, 5.0], None),
                   ([6.0, 7.0, 8.0], None), ([9.0], None)]
    got = tmesh.on_shares(lambda dev, a: a.tolist(), [CPU] * 4, x[:2])
    assert got == [[0.0], [1.0]]


# --- the tiled halo solve -----------------------------------------------------


@pytest.mark.parametrize("rows, size, halo, shift", [
    (4, (128, 96), None, (1.5, 0.75)),  # the default halo: 32 rows here
    (8, (128, 64), 16, (-1.0, 2.0)),
])
def test_tiled_equals_the_jax_package_and_the_monolithic_solve(
        rows, size, halo, shift):
    """tests/test_dist.py's 4- and 8-shard cases: within 1e-3 px of the JAX
    tiled solve on every row, within the JAX test's 0.25 px of the port's
    monolithic solve on every row, seams included (8 px column margin), and
    EPE < 0.4 px."""
    rng = np.random.default_rng(1234)
    im0 = make_fibsem_like(rng, *size)
    im1 = translate(im0, *shift)
    jp, tp = both_params(**TILED)
    want = jax_tiled(im0, im1, jp, jax_mesh(1, rows), halo=halo)
    got = port_tiled(im0, im1, tp, cpu_mesh(1, rows), halo=halo)
    assert got.shape == size + (2,)
    assert np.abs(got - want).max() <= 1e-3
    mono = ttv.tvl1_flow(torch.from_numpy(im0), torch.from_numpy(im1),
                         tp).numpy()
    assert float(np.abs(got - mono)[:, 8:-8].max()) < 0.25
    assert mean_epe(got, *shift, margin=12) < 0.4


@pytest.mark.parametrize("nscales", [1, 2, 3, 5, 10])
@pytest.mark.parametrize("scale_step", [0.5, 0.8, 0.9])
def test_default_halo_equals_the_jax_package(nscales, scale_step):
    jp, tp = both_params(nscales=nscales, scale_step=scale_step)
    for max_flow in (2.0, 4.0, 8.0, 32.0):
        for hw in ((1 << 30, 1 << 30), (64, 64), (1024, 2048), (40, 300)):
            assert ttiled.default_halo(tp, max_flow, *hw) == \
                jtiled.default_halo(jp, max_flow, *hw)
    assert ttiled.default_halo(TVL1Params(), max_flow=8.0) == 40


def test_ring_equals_gather_bit_for_bit():
    im0 = make_fibsem_like(np.random.default_rng(1234), 128, 96)
    im1 = translate(im0, 1.5, 0.75)
    tp = TVL1Params(**TILED)
    mesh = cpu_mesh(1, 4)
    ring = port_tiled(im0, im1, tp, mesh, neighbor_exchange=True)
    gathered = port_tiled(im0, im1, tp, mesh, neighbor_exchange=False)
    assert np.array_equal(ring, gathered)


def test_tiled_windows_are_true_slices(monkeypatch):
    """Both exchanges hand every device the clamped window of the global
    image: an image whose rows are their own index shows each window's
    rows, 4 shards of 32 rows, halo 16 (ring) and 24 (ring demoted)."""
    seen = []

    def record(a, b, params):
        seen.append(a[:, 0].clone())
        return torch.zeros(a.shape + (2,))

    img = np.repeat(np.arange(128, dtype=np.float32)[:, None], 8, axis=1)
    monkeypatch.setattr(ttiled, "tvl1_flow", record)
    for halo, exchange in ((16, True), (16, False), (24, None)):
        seen.clear()
        ttiled.tiled_tvl1_flow(img, img, TVL1Params(), cpu_mesh(1, 4),
                               halo=halo, neighbor_exchange=exchange)
        win = 32 + 2 * halo
        starts = [min(max(d * 32 - halo, 0), 128 - win) for d in range(4)]
        assert sorted(int(s[0]) for s in seen) == starts
        for s in seen:
            assert torch.equal(s, torch.arange(int(s[0]), int(s[0]) + win,
                                               dtype=torch.float32))


def test_tiled_clip_telemetry_and_strict(rng):
    """A 6 px shift against max_flow 2: clamped, reported, and raised under
    strict; an in-contract solve reports 0. The clamped flows within 1e-3
    px of the JAX package's, the clip fractions within 0.01."""
    im0 = make_fibsem_like(rng, 64, 64)
    im1 = translate(im0, 6.0, 0.0)
    jp, tp = both_params(nscales=3, warps=2, iterations=40)
    mesh = cpu_mesh(1, 4)
    got = port_tiled(im0, im1, tp, mesh, halo=16, max_flow=2.0)
    frac = ttiled.get_last_clip_fraction()
    want = jax_tiled(im0, im1, jp, jax_mesh(1, 4), halo=16, max_flow=2.0)
    assert float(np.abs(got).max()) <= 2.0 + 1e-6
    assert np.abs(got - want).max() <= 1e-3
    assert frac > 0.0
    assert abs(frac - jtiled.get_last_clip_fraction()) <= 0.01
    with pytest.raises(ValueError, match="max_flow"):
        port_tiled(im0, im1, tp, mesh, halo=16, max_flow=2.0, strict=True)
    port_tiled(im0, translate(im0, 1.0, 0.0), tp, mesh, halo=16,
               max_flow=8.0)
    assert ttiled.get_last_clip_fraction() == 0.0


def test_tiled_halo_shrink_is_surfaced(rng):
    im0 = make_fibsem_like(rng, 64, 64)  # block 16, the widest halo 24
    im1 = translate(im0, 1.0, 0.5)
    tp = TVL1Params(nscales=2, warps=2, iterations=30)
    mesh = cpu_mesh(1, 4)
    with pytest.warns(RuntimeWarning, match="halo shrunk 32 -> 24"):
        port_tiled(im0, im1, tp, mesh, halo=32)
    assert ttiled.get_last_halo_shortfall() == 8
    with pytest.raises(ValueError, match="halo shrunk"):
        port_tiled(im0, im1, tp, mesh, halo=32, strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_tiled(im0, im1, tp, mesh, halo=16)
    assert ttiled.get_last_halo_shortfall() == 0


def test_tiled_forced_ring_demotes_when_halo_too_wide(rng):
    im0 = make_fibsem_like(rng, 128, 64)  # block 32
    im1 = translate(im0, 1.0, -0.5)
    tp = TVL1Params(nscales=2, warps=2, iterations=30)
    mesh = cpu_mesh(1, 4)
    with pytest.warns(RuntimeWarning, match="demoted to all_gather"):
        forced = port_tiled(im0, im1, tp, mesh, halo=24,
                            neighbor_exchange=True)
    gathered = port_tiled(im0, im1, tp, mesh, halo=24,
                          neighbor_exchange=False)
    assert np.array_equal(forced, gathered)


def test_tiled_clip_ignores_discarded_halo_rows(rng):
    im0 = make_fibsem_like(rng, 64, 64)
    im1 = translate(im0, 0.5, 0.0)
    tp = TVL1Params(**TILED)
    flow = port_tiled(im0, im1, tp, cpu_mesh(1, 2), halo=16, max_flow=8.0)
    assert float(np.abs(flow).max()) <= 8.0
    assert ttiled.get_last_clip_fraction() == 0.0


def test_clip_telemetry_is_per_thread(rng):
    """Two threads' tiled solves, one out of contract: each thread reads
    its own clip fraction and halo shortfall."""
    im0 = make_fibsem_like(rng, 64, 64)
    tp = TVL1Params(nscales=2, warps=1, iterations=20)
    out = {}

    def run(name, shift, halo):
        port_tiled(im0, translate(im0, shift, 0.0), tp, cpu_mesh(1, 2),
                   halo=halo, max_flow=2.0)
        out[name] = (ttiled.get_last_clip_fraction(),
                     ttiled.get_last_halo_shortfall())

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        threads = [threading.Thread(target=run, args=("clip", 6.0, 40)),
                   threading.Thread(target=run, args=("calm", 0.5, 8))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert out["clip"][0] > 0.0 and out["clip"][1] == 40 - 16
    assert out["calm"] == (0.0, 0)


# --- the batch runner on a mesh -----------------------------------------------


def _flow_job(names, out_dir, output_type="flow"):
    images = [{"p": names[z], "q": names[z + 1], "output_name": f"n{z}",
               "pId": f"t{z}", "qId": f"t{z + 1}", "pGroupId": f"{z}.0",
               "qGroupId": f"{z + 1}.0"}
              for z in range(len(names) - 1)]
    return {"style": 1, "scale": 1.0, "output_type": output_type,
            "output_dir": str(out_dir), "rois": {"top": 24, "bottom": 24},
            "pair_batch": 3, "features": False, "match_sink": "null",
            "npoints": 10, "batch_size": 100, **FAST, "images": images}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    base = make_fibsem_like(rng, 64, 80)
    return {f"mem://f{z}": translate(base, 0.8 * z, -0.5 * z)
            for z in range(8)}


def test_run_job_batched_on_a_mesh_equals_the_jax_package(frames, tmp_path):
    """7 pairs of two strip ROIs, `flow` TIFFs, over 4 pairs devices
    (pair_batch 3 rounds up to 4: groups of 4 and 3): equal stats and
    files, fields within 1e-3 px of the JAX package's on its 4-device
    mesh, and equal to the port's single-device run."""
    from optflow_tpu_torch.core.imgio import read_float_tiff

    names = sorted(frames)
    runs = {}
    for side in ("jax", "port", "single"):
        job = _flow_job(names, tmp_path / side)
        loader = (lambda p, s: frames[p])
        if side == "jax":
            runs[side] = jbr.run_job_batched(job, loader=loader,
                                             mesh=jax_mesh(4, 1))
        elif side == "port":
            runs[side] = tbr.run_job_batched(job, loader=loader,
                                             mesh=cpu_mesh(4, n=4))
        else:
            runs[side] = tbr.run_job_batched(job, loader=loader,
                                             device="cpu")
    for key in ("pairs", "batched", "sequential", "uploads", "matches",
                "skipped"):
        assert runs["port"][key] == runs["jax"][key] == runs["single"][key]
    assert runs["port"]["pairs"] == 7 and runs["port"]["solve_device"] == "cpu"
    files = sorted(f.name for f in (tmp_path / "port").iterdir())
    assert files == sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert len(files) == 7 * 2 * 2
    for name in files:
        got = read_float_tiff(str(tmp_path / "port" / name))
        assert np.abs(got - read_float_tiff(str(tmp_path / "jax" / name))
                      ).max() <= 1e-3
        assert np.array_equal(
            got, read_float_tiff(str(tmp_path / "single" / name)))


def test_job_devices_keep_an_indexed_card(monkeypatch):
    """With two visible cards and no mesh, the unindexed ``cuda`` spreads
    a job over both, an indexed card stays alone, a mesh is taken as given
    (the visible cards are simulated; nothing runs on them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert tbr._job_devices(torch.device("cuda"), None) == cuda
    assert tbr._job_devices(torch.device("cuda:1"), None) == cuda[1:]
    assert tbr._job_devices(CPU, None) == [CPU]
    assert tbr._job_devices(torch.device("cuda"), cpu_mesh(3, n=3)) \
        == [CPU] * 3


def test_random_points_on_a_mesh_take_the_host_path(frames):
    """random_points over 4 pairs devices: the host path (the device group
    engages only on one device), the JAX package's stats."""
    names = sorted(frames)
    stats = {}
    for side in ("jax", "port"):
        job = _flow_job(names, "unused", output_type="random_points")
        if side == "jax":
            stats[side] = jbr.run_job_batched(
                job, sink=_Null(), loader=lambda p, s: frames[p],
                mesh=jax_mesh(4, 1))
        else:
            stats[side] = tbr.run_job_batched(
                job, sink=_Null(), loader=lambda p, s: frames[p],
                mesh=cpu_mesh(4, n=4))
    for key in ("pairs", "batched", "uploads", "matches"):
        assert stats["port"][key] == stats["jax"][key], key
    assert stats["port"]["matches"] == 7 * 2 * 10
    assert "sample_s" not in stats["port"]["timing"]


class _Null:
    def put(self, matches):
        return True


# --- the sharded alignment solves ---------------------------------------------


def test_sharded_translation_cg_equals_the_jax_package(rng):
    """tests/test_align.py's case: within 1e-3 px of the JAX sharded and
    the port's single-device solve, residual within 1e-3, truth within
    0.4 px."""
    true = np.cumsum(rng.uniform(-4, 4, size=(12, 2)), axis=0)
    true -= true[0]
    recs = _make_matches(true, n_pts=15, noise=0.2, rng=rng)
    want = jdist.solve_translation_alignment_sharded(recs, jax_mesh())
    got = tdist.solve_translation_alignment_sharded(recs, cpu_mesh())
    single = tgs.solve_translation_alignment(recs, device="cpu")
    for other in (want, single):
        assert np.abs(got.transforms - np.asarray(other.transforms)).max() \
            <= 1e-3
        assert abs(got.residual - other.residual) <= 1e-3
    t = got.transforms[:, :, 2] - got.transforms[0, :, 2]
    assert np.abs(t - true).max() < 0.4


def test_sharded_affine_cg_equals_the_jax_package(rng):
    true = _small_affines(rng, 10)
    recs = _make_affine_matches(true, rng=rng)
    want = jdist.solve_affine_alignment_sharded(recs, jax_mesh())
    got = tdist.solve_affine_alignment_sharded(recs, cpu_mesh())
    single = tgs.solve_affine_alignment(recs, device="cpu")
    for other in (want, single):
        assert np.abs(got.transforms - np.asarray(other.transforms)).max() \
            <= 1e-3
    assert got.residual < 0.1


def test_sharded_solves_of_no_matches():
    recs = [{"pGroupId": "1.0", "qGroupId": "2.0", "pId": "a", "qId": "b",
             "matches": {"p": [[-1], [-1]], "q": [[-1], [-1]], "w": [0]}}]
    for solve in (tdist.solve_translation_alignment_sharded,
                  tdist.solve_affine_alignment_sharded):
        res = solve(recs, cpu_mesh())
        assert res.residual == 0.0 and res.transforms.shape == (2, 2, 3)


def test_sharded_zblock_translation_equals_the_jax_package():
    """tests/test_align.py's 520-section case, blocks of 64 over 8 devices:
    within 1e-6 px of the port's unsharded solve (both float64) and 1e-4 px
    of scipy's exact solve of the same equations (chip_smoke.py's
    reference), truth 0.5 px. The JAX sharded solve factorises in float32,
    which lands it 0.0141 px from the exact solve here: the port is held
    within 0.02 px of it."""
    rng = np.random.default_rng(11)
    z = 520
    true = np.cumsum(rng.uniform(-2, 2, size=(z, 2)), axis=0)
    true -= true[0]
    recs = _make_matches(true, n_pts=4, noise=0.05, rng=rng, z_dist=3)
    want = jzb.solve_zblock_alignment(recs, model="translation",
                                      block_sections=64, mesh=jax_mesh())
    got = tzb.solve_zblock_alignment(recs, model="translation",
                                     block_sections=64, device="cpu",
                                     mesh=cpu_mesh())
    single = tzb.solve_zblock_alignment(recs, model="translation",
                                        block_sections=64, device="cpu")
    exact = chip_smoke.exact_alignment(tgs._collect_edges(recs),
                                       "translation")
    assert np.abs(got.transforms - single.transforms).max() <= 1e-6
    assert np.abs(got.transforms - exact).max() <= 1e-4
    assert np.abs(got.transforms - np.asarray(want.transforms)).max() <= 0.02
    t = got.transforms[:, :, 2] - got.transforms[0, :, 2]
    assert np.abs(t - true).max() < 0.5


def test_sharded_zblock_affine_pads_with_identity_blocks():
    """30 sections in blocks of 10 over 4 devices (3 blocks and one
    identity block of padding): within 1e-4 of the port's unsharded solve,
    the JAX sharded solve within the JAX z-block test's gates (linear 1e-3,
    translation 0.01 px, as tests/test_torch_align.py compares them)."""
    rng = np.random.default_rng(3)
    true = _small_affines(rng, 30)
    recs = _make_affine_matches(true, rng=rng, z_dist=3)
    got = tzb.solve_zblock_alignment(recs, model="affine", block_sections=10,
                                     device="cpu", mesh=cpu_mesh(4, n=4))
    single = tzb.solve_zblock_alignment(recs, model="affine",
                                        block_sections=10, device="cpu")
    want = jzb.solve_zblock_alignment(recs, model="affine", block_sections=10,
                                      mesh=jax_mesh(4, 1))
    assert np.abs(got.transforms - single.transforms).max() <= 1e-4
    want = np.asarray(want.transforms)
    assert np.abs(got.transforms[:, :, :2] - want[:, :, :2]).max() <= 1e-3
    assert np.abs(got.transforms[:, :, 2] - want[:, :, 2]).max() <= 0.01
    assert got.residual < 0.05


# --- the kernel wrappers from one thread per device ----------------------------


def test_four_threads_solve_as_a_sequential_loop(rng):
    """Four threads on [cpu] * 4 each solve their own pair: the flows equal
    a sequential loop's bit for bit, and each thread reads its own
    iteration counts (ops.tvl1.get_last_iteration_stats)."""
    tp = TVL1Params(nscales=2, warps=2, iterations=30, epsilon=0.05)
    ims = [make_fibsem_like(rng, 32, 48) for _ in range(4)]
    pairs = [(torch.from_numpy(im)[None],
              torch.from_numpy(translate(im, 0.3 * (k + 1), 0.0))[None])
             for k, im in enumerate(ims)]
    want, want_stats = [], []
    for a, b in pairs:
        want.append(ttv.tvl1_flow_batched(a, b, tp))
        want_stats.append([it.tolist() for _, it in
                           ttv.get_last_iteration_stats()])
    assert len({str(s) for s in want_stats}) > 1  # the counts tell them apart

    def solve(dev, a, b):
        flow = ttv.tvl1_flow_batched(a, b, tp)
        return flow, [it.tolist() for _, it in ttv.get_last_iteration_stats()]

    got = tmesh.on_devices(solve, [CPU] * 4, *zip(*pairs))
    for (flow, stats), w, ws in zip(got, want, want_stats):
        assert torch.equal(flow, w)
        assert stats == ws


def test_launch_counts_add_up_under_thread_switches():
    """The count of a wrapper under 16 threads adding at a shortened switch
    interval: no launch lost; ``last_work`` is each thread's own."""
    fn = _build.counted_launches(lambda: None)
    seen = {}

    def work(k):
        for _ in range(500):
            fn.count_launch(work=k)
        seen[k] = fn.last_work

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 16 * 500
    assert seen == {k: k for k in range(16)}
    assert fn.last_work is None  # this thread launched nothing
    fn.launches = 0
    assert fn.launches == 0


# --- on the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_four_threads_on_one_card_launch_four_calls_worth():
    """Four threads each solve a level on cuda:0: the level kernel's
    library tally rises by exactly four calls' launches, the wrapper's
    count by four, and the results equal one thread's."""
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_level_solve

    card = _card()
    rng = np.random.default_rng(2)
    im0 = make_fibsem_like(rng, 64, 128)
    i0 = torch.from_numpy(im0)[None].to(card)
    i1 = torch.from_numpy(translate(im0, 1.0, 0.5))[None].to(card)
    z = torch.zeros_like(i0)
    tp = TVL1Params(warps=2, iterations=20)
    k0, _ = _build.enqueued()
    ref = tvl1_level_solve(i0, i1, z, z, tp)
    one = _build.enqueued()[0] - k0
    assert one >= 1
    before = tvl1_level_solve.launches
    k0, _ = _build.enqueued()
    outs = tmesh.on_devices(lambda dev: tvl1_level_solve(i0, i1, z, z, tp),
                            [card] * 4)
    torch.cuda.synchronize()
    assert _build.enqueued()[0] - k0 == 4 * one
    assert tvl1_level_solve.launches - before == 4
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.gpu
def test_threads_solving_different_shapes_on_one_card_equal_alone():
    """Eight threads on cuda:0, each solving its own shape at the same time
    (another shared memory size a launch, one of them through the blocked
    kernel), five times over: no launch is refused and every flow equals
    the same solve made alone, bit for bit."""
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_flow_batched_cuda

    card = _card()
    rng = np.random.default_rng(3)
    inputs = []
    for h in (64, 96, 136, 200, 264, 328, 392, 840):
        a = rng.random((1, h, 512), dtype=np.float32)
        inputs.append((torch.from_numpy(a).to(card),
                       torch.from_numpy(np.roll(a, 1, axis=-1)).to(card)))
    tp = TVL1Params()
    alone = [tvl1_flow_batched_cuda(a, b, tp) for a, b in inputs]
    for _ in range(5):
        outs = tmesh.on_devices(
            lambda dev, i: tvl1_flow_batched_cuda(*inputs[i], tp),
            [card] * len(inputs), range(len(inputs)))
        torch.cuda.synchronize()
        assert all(torch.equal(o, f) for o, f in zip(outs, alone))


@pytest.mark.gpu
def test_scheduler_and_tiled_solve_on_the_card(rng):
    """The scheduler over [cuda:0] * 4 equals one batched call (1e-4 px,
    one stream: the shards run in turn); the tiled solve over 4 rows is
    within 0.25 px of the monolithic solve on every row."""
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_flow_batched_cuda

    card = _card()
    tp = TVL1Params()
    ims = [make_fibsem_like(rng, 128, 256) for _ in range(8)]
    pairs = [(im, translate(im, 1.2, -0.7)) for im in ims]
    mesh = tmesh.make_pair_mesh(devices=[card] * 4)
    got = PairScheduler(mesh, tp).solve_pairs(pairs)
    one = tvl1_flow_batched_cuda(
        torch.from_numpy(np.stack([p[0] for p in pairs])).to(card),
        torch.from_numpy(np.stack([p[1] for p in pairs])).to(card), tp,
    ).cpu().numpy()
    assert max(float(np.abs(g - o).max()) for g, o in zip(got, one)) <= 1e-4
    im0 = make_fibsem_like(rng, 512, 256)
    im1 = translate(im0, 1.5, 0.75)
    tiled = ttiled.tiled_tvl1_flow(im0, im1, tp, tmesh.make_pair_mesh(
        1, 4, devices=[card] * 4))
    mono = tvl1_flow_batched_cuda(torch.from_numpy(im0)[None].to(card),
                                  torch.from_numpy(im1)[None].to(card), tp)[0]
    assert tiled.device == card
    assert float((tiled - mono).abs()[:, 8:-8].max()) < 0.25
