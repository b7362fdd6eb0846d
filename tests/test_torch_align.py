"""The port's global alignment and style 2 against the JAX package's, on the
CPU: the edge arrays, the z-block assembly, the CG and z-block solves on the
cases of tests/test_align.py (the sharded ones are in
tests/test_torch_dist.py), the sampler and the upsampling style 2 uses, the style-2 job,
both CLIs, and the gen -> solve -> convert -> align loop. The same seeded
numpy inputs go through both packages; tolerances are stated per test."""

import gzip
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi
import torch

from optflow_tpu.align import average_flow as jaf
from optflow_tpu.align import global_solve as jgs
from optflow_tpu.align import zblock as jzb
from optflow_tpu.ops.warp import bilinear_sample as j_bilinear_sample
from optflow_tpu_torch.align import average_flow as taf
from optflow_tpu_torch.align import global_solve as tgs
from optflow_tpu_torch.align import zblock as tzb
from optflow_tpu_torch.ops.pyramid import resize_bilinear
from optflow_tpu_torch.ops.warp import bilinear_sample
import chip_smoke
from tests.conftest import make_fibsem_like
from tests.test_align import _make_affine_matches, _make_matches, _small_affines

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)


def _offsets(seed, z, step):
    true = np.cumsum(np.random.default_rng(seed).uniform(-step, step, (z, 2)),
                     axis=0)
    return true - true[0]


def _mixed_records():
    """Matches with dummy (w = 0), negative and fractional weights, a pair
    seen twice, a same-section pair, and non-numeric group ids."""
    rng = np.random.default_rng(2)
    recs = _make_matches(_offsets(2, 6, 3), n_pts=5, noise=0.2, rng=rng)
    recs[1]["matches"]["w"] = [0.0, 1.0, -1.0, 0.5, 2.0]
    recs.append({"pGroupId": "3.0", "qGroupId": "3.0", "pId": "x",
                 "qId": "y", "matches": {"p": [[1.0, 2.0], [3.0, 4.0]],
                                         "q": [[1.5, 2.5], [3.5, 4.5]],
                                         "w": [1.0, 0.25]}})
    recs.append({"pGroupId": "sec_b", "qGroupId": "0.0", "pId": "u",
                 "qId": "v", "matches": {"p": [[-1], [-1]], "q": [[-1], [-1]],
                                         "w": [0]}})
    recs.append(dict(recs[0]))
    return recs


def test_collect_edges_arrays_equal():
    recs = _mixed_records()
    want = jgs._collect_edges(recs)
    got = tgs._collect_edges(recs)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    empty = tgs._collect_edges([])
    assert empty[0] == [] and all(len(x) == 0 for x in empty[1:])


def _capture_systems(monkeypatch, recs, model, block_sections):
    """The assembled systems that both packages hand to their _schur_solve:
    the JAX package's per-edge loop and the port's vectorised assembly, each
    after regularisation and the gauge pin."""
    seen = {}

    def grab(name, real):
        def fake(A_II, A_IS, A_SS, r_I, r_S, *rest):
            seen[name] = [np.array(t) for t in (A_II, A_IS, A_SS, r_I, r_S)]
            return real(A_II, A_IS, A_SS, r_I, r_S, *rest)
        return fake

    monkeypatch.setattr(jzb, "_schur_solve", grab("jax", jzb._schur_solve))
    monkeypatch.setattr(tzb, "_schur_solve", grab("port", tzb._schur_solve))
    jzb.solve_zblock_alignment(recs, model=model, block_sections=block_sections)
    tzb.solve_zblock_alignment(recs, model=model,
                               block_sections=block_sections, device="cpu")
    return seen["jax"], seen["port"]


@pytest.mark.parametrize("model", ["translation", "affine"])
@pytest.mark.parametrize("graph", ["banded", "mixed"])
def test_vectorised_assembly_equals_the_jax_loop(monkeypatch, model, graph):
    """A_II, A_IS, A_SS, r_I, r_S equal the JAX loop's in float64 up to the
    order of the float64 sums: within 1e-12 of the largest entry. Blocks of
    4 sections, so separators exist; the mixed graph adds a same-section
    pair and an edge across every block."""
    if graph == "banded":
        recs = _make_affine_matches(_small_affines(np.random.default_rng(4),
                                                   13), n_pts=6, z_dist=3)
    else:
        recs = _mixed_records()
        recs += _make_matches(_offsets(5, 13, 2), n_pts=3,
                              rng=np.random.default_rng(5), z_dist=12)[:12]
    want, got = _capture_systems(monkeypatch, recs, model, 4)
    assert got[2].shape[0] > 0  # separators exist
    for a, b in zip(got, want):
        assert a.dtype == np.float64 and a.shape == b.shape
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() <= 1e-12 * scale


def _recovers_offsets():
    rng = np.random.default_rng(1234)
    true = np.cumsum(rng.uniform(-5, 5, size=(10, 2)), axis=0)
    true -= true[0]
    return _make_matches(true, rng=rng), true, 0.05


def _recovers_noisy():
    rng = np.random.default_rng(1234)
    true = np.cumsum(rng.uniform(-3, 3, size=(20, 2)), axis=0)
    true -= true[0]
    return _make_matches(true, noise=0.5, rng=rng), true, 0.6


def _zblock_translation():
    rng = np.random.default_rng(7)
    true = np.cumsum(rng.uniform(-4, 4, size=(25, 2)), axis=0)
    true -= true[0]
    return _make_matches(true, n_pts=12, noise=0.1, rng=rng, z_dist=3), true, 0.5


@pytest.mark.parametrize("case", [_recovers_offsets, _recovers_noisy,
                                  _zblock_translation])
@pytest.mark.parametrize("solver", ["cg", "zblock"])
def test_translation_solves_agree_with_the_jax_package(case, solver):
    """Offsets within 1e-3 px of the JAX function's (CG: float32 sums in
    another order; z-block: the same system, factorised in float64 where
    the JAX package factorises in float32), and within the JAX test's gate
    of the truth."""
    recs, true, gate = case()
    if solver == "cg":
        want = jgs.solve_translation_alignment(recs)
        got = tgs.solve_translation_alignment(recs, device="cpu")
    else:
        want = jzb.solve_zblock_alignment(recs, model="translation",
                                          block_sections=8)
        got = tzb.solve_zblock_alignment(recs, model="translation",
                                         block_sections=8, device="cpu")
    assert got.group_ids == want.group_ids
    assert got.transforms.dtype == np.float32
    assert np.abs(got.transforms - want.transforms).max() <= 1e-3
    assert abs(got.residual - want.residual) <= 1e-3
    t = got.transforms[:, :, 2] - got.transforms[0, :, 2]
    assert np.abs(t - true).max() <= gate


def test_dummy_matches_are_ignored_alike():
    recs = [{
        "pGroupId": "1.0", "qGroupId": "2.0", "pId": "a", "qId": "b",
        "matches": {"p": [[-1], [-1]], "q": [[-1], [-1]], "w": [0]},
    }]
    for solve in (tgs.solve_translation_alignment, tgs.solve_affine_alignment):
        res = solve(recs, device="cpu")
        assert res.residual == 0.0 and res.group_ids == ["1.0", "2.0"]
    want = jgs.solve_translation_alignment(recs)
    got = tgs.solve_translation_alignment(recs, device="cpu")
    assert np.array_equal(got.transforms, want.transforms)
    res = tzb.solve_zblock_alignment(recs, device="cpu")
    assert res.residual == 0.0 and res.transforms.shape == (2, 2, 3)


def test_affine_cg_agrees_with_the_jax_package():
    """Small rotations per section (tests/test_align.py's case): affines
    within 1e-3 of the JAX function's, residual under its gate 0.2 px."""
    rng = np.random.default_rng(1234)
    z = 6
    angles = np.linspace(0, 0.02, z)
    recs = []
    for a in range(z - 1):
        g = rng.uniform(100, 400, size=(25, 2))

        def to_sec(g, th):
            c, s = np.cos(th), np.sin(th)
            return g @ np.array([[c, s], [-s, c]]).T

        p, q = to_sec(g, angles[a]), to_sec(g, angles[a + 1])
        recs.append({"pGroupId": f"{a}.0", "qGroupId": f"{a + 1}.0",
                     "pId": f"t{a}", "qId": f"t{a + 1}",
                     "matches": {"p": p.T.tolist(), "q": q.T.tolist(),
                                 "w": [1.0] * 25}})
    want = jgs.solve_affine_alignment(recs, reg_lambda=1e-4)
    got = tgs.solve_affine_alignment(recs, reg_lambda=1e-4, device="cpu")
    assert np.abs(got.transforms - want.transforms).max() <= 1e-3
    assert abs(got.residual - want.residual) <= 1e-3
    assert got.residual < 0.2


@pytest.fixture(scope="module")
def production_affine_stack():
    """chip_smoke.py's affine stack: 9,604 sections at z-distance <= 3."""
    recs, _, _ = chip_smoke.alignment_graph(chip_smoke.ALIGN_SECTIONS,
                                            seed=11, affine=True)
    return recs


@pytest.mark.parametrize("n", [8, chip_smoke.ALIGN_CG_SECTIONS])
def test_affine_cg_stops_where_the_jax_cg_stops(production_affine_stack, n):
    """On the first n sections of chip_smoke.py's affine stack the port's
    CG and the JAX package's stop at the same relative objective excess
    over the exact optimum: on 8 sections both reach the optimum (excess
    <= 1e-4); on 256 neither converges in its 400 iterations and the two
    excesses agree within 1 % (an unconverged float32 CG's path follows its
    sums' order), and the JAX package's is the one chip_smoke.py holds the
    card to (AFFINE_CG_JAX_EXCESS, within 1e-3). With ``-s`` it prints
    both excesses and both solutions' distance from the z-block solve."""
    sub = chip_smoke.first_sections(production_affine_stack, n)
    jax_t = np.asarray(jgs.solve_affine_alignment(sub).transforms)
    port_t = tgs.solve_affine_alignment(sub, device="cpu").transforms
    want = chip_smoke.objective_excess(sub, jax_t, "affine")
    got = chip_smoke.objective_excess(sub, port_t, "affine")
    zb = tzb.solve_zblock_alignment(sub, model="affine", device="cpu")
    print(json.dumps({
        "sections": n, "excess_jax": want, "excess_port": got,
        "jax_vs_zblock_px": chip_smoke.corner_gap(jax_t, zb.transforms),
        "port_vs_zblock_px": chip_smoke.corner_gap(port_t, zb.transforms),
        "jax_vs_port_px": chip_smoke.corner_gap(jax_t, port_t)}))
    if n == 8:
        assert want <= 1e-4 and got <= 1e-4
    else:
        assert abs(got / want - 1.0) <= 1e-2
        assert abs(want / chip_smoke.AFFINE_CG_JAX_EXCESS - 1.0) <= 1e-3


def test_affine_solves_agree_with_the_jax_package():
    """tests/test_align.py's z-block affine case (30 sections, blocks of 10)
    and the affine CG on its first 10 sections: linear parts within 1e-3
    and translations within 0.01 px of the JAX functions', both within the
    JAX test's gates of the truth."""
    rng = np.random.default_rng(3)
    true = _small_affines(rng, 30)
    recs = _make_affine_matches(true, rng=rng, z_dist=3)
    want = jzb.solve_zblock_alignment(recs, model="affine", block_sections=10)
    got = tzb.solve_zblock_alignment(recs, model="affine", block_sections=10,
                                     device="cpu")
    sub = [r for r in recs if float(r["qGroupId"]) < 10]
    cg_want = jgs.solve_affine_alignment(sub)
    cg_got = tgs.solve_affine_alignment(sub, device="cpu")
    for g, w, n in ((got, want, 30), (cg_got, cg_want, 10)):
        assert np.abs(g.transforms[:, :, :2] - w.transforms[:, :, :2]).max() \
            <= 1e-3
        assert np.abs(g.transforms[:, :, 2] - w.transforms[:, :, 2]).max() \
            <= 0.01
        assert np.allclose(g.transforms[:, :, :2], true[:n, :, :2], atol=5e-3)
        assert np.allclose(g.transforms[:, :, 2], true[:n, :, 2], atol=0.3)
    assert got.residual < 0.05 and cg_got.residual < 0.1


@pytest.mark.parametrize("coords", ["scattered", "remap"])
def test_bilinear_sample_equals_the_jax_sampler(coords):
    """Clamp-to-edge bilinear sampling within 1e-4 gray levels of the JAX
    sampler (its default, ``cubic_hat=False``, the one style 2 uses): at
    scattered coordinates inside, on and far outside the image, and on the
    pixel grid less a flow of up to 3 px, as the style-2 remap samples."""
    rng = np.random.default_rng(8)
    im = make_fibsem_like(rng, 20, 30)
    if coords == "scattered":
        x = rng.uniform(-5, 35, (17, 13)).astype(np.float32)
        y = rng.uniform(-5, 25, (17, 13)).astype(np.float32)
        x[0, :3] = [0.0, 29.0, 29.5]
        y[0, :3] = [19.0, 0.0, 19.0]
    else:
        gy, gx = np.mgrid[0:20, 0:30].astype(np.float32)
        x = gx - rng.uniform(-3, 3, gx.shape).astype(np.float32)
        y = gy - rng.uniform(-3, 3, gy.shape).astype(np.float32)
    want = np.asarray(j_bilinear_sample(jnp.asarray(im), jnp.asarray(x),
                                        jnp.asarray(y)))
    got = bilinear_sample(torch.from_numpy(im), torch.from_numpy(x),
                          torch.from_numpy(y)).numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_weights_equal():
    assert taf.WEIGHTS == jaf.WEIGHTS
    assert abs(sum(taf.WEIGHTS) - 1.0) < 1e-9


@pytest.mark.parametrize("shape,scale", [((48, 64), 0.5), ((47, 66), 0.5),
                                         ((40, 56), 0.25), ((48, 64), 1.0)])
def test_flow_upsampling_equals_jax_image_resize(shape, scale):
    """The style-2 flow upsampling (resize_bilinear of the (2, h, w) field)
    against the JAX package's jax.image.resize(..., "linear",
    antialias=False) of the (h, w, 2) field, edges included: within 1e-5 px
    on a field of +-10 px."""
    h, w = shape
    sh = (int(round(h * scale)), int(round(w * scale)))
    flow_s = np.random.default_rng(9).uniform(-10, 10, sh + (2,)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(flow_s), (h, w, 2),
                                       "linear", antialias=False))
    got = resize_bilinear(torch.from_numpy(flow_s).permute(2, 0, 1),
                          (h, w)).permute(1, 2, 0).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def _drifting_stack(tmp_path, n=9, h=48, w=64, step=0.8):
    """tests/test_align.py's style-2 stack: sections drifting in x."""
    from PIL import Image

    base = make_fibsem_like(np.random.default_rng(1234), h, w)
    paths = []
    ys, xs = np.mgrid[0:h, 0:w].astype(float)
    for i in range(n):
        im = ndi.map_coordinates(base, [ys, xs - i * step], order=3,
                                 mode="nearest")
        p = tmp_path / f"s{i}.png"
        Image.fromarray(im.astype(np.uint8)).save(str(p))
        paths.append(str(p))
    return paths


def _style2_job(paths, out_dir, **kw):
    job = {"style": 2, "file_list": paths, "output_dir": str(out_dir),
           "scale": 1.0, "border": 0, "nscales": 2, "warps": 2,
           "iterations": 30}
    job.update(kw)
    return job


@pytest.mark.parametrize("scale,border", [(1.0, 0), (0.5, 3)])
def test_average_flow_job_writes_the_jax_package_s_sections(tmp_path, capsys,
                                                            scale, border):
    """9 sections of 48x64 with the JAX test's settings (and at scale 0.5
    with a border): the same files, the same progress lines, and every
    output section within 0.05 gray levels of the JAX package's (the plain
    solvers of both, float32 sums in another order)."""
    from optflow_tpu.core.imgio import read_float_tiff

    paths = _drifting_stack(tmp_path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jaf.average_flow_job(
        _style2_job(paths, tmp_path / "jax", scale=scale, border=border))
    jax_out = capsys.readouterr().out
    got = taf.average_flow_job(
        _style2_job(paths, tmp_path / "port", scale=scale, border=border),
        device="cpu")
    assert capsys.readouterr().out == jax_out
    assert [p.replace("/port/", "/jax/") for p in got] == want
    assert len(got) == 3  # sections 3, 4, 5
    for g, w in zip(got, want):
        a, b = read_float_tiff(g), read_float_tiff(w)
        assert a.shape == b.shape == (48 + 2 * border, 64 + 2 * border)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 0.05


def test_average_flow_needs_seven_sections(tmp_path):
    with pytest.raises(ValueError, match="at least 7"):
        taf.average_flow_job({"style": 2, "file_list": ["a"] * 6},
                             device="cpu")


def _write_store(path, recs):
    from optflow_tpu_torch.sinks.store import JsonlMatchSink

    JsonlMatchSink(str(path)).put(recs)


@pytest.mark.parametrize("model,solver", [("translation", "zblock"),
                                          ("affine", "zblock"),
                                          ("translation", "cg")])
def test_cli_align_agrees_with_the_jax_cli(tmp_path, capsys, model, solver):
    """Both CLIs on one JSONL store: the same keys, model and section ids,
    transforms within 1e-3, and recovered offsets within the JAX test's
    0.3 px."""
    from optflow_tpu.cli.main import main as jmain
    from optflow_tpu_torch.cli.main import main as tmain

    rng = np.random.default_rng(5)
    true = np.cumsum(rng.uniform(-3, 3, size=(12, 2)), axis=0)
    true -= true[0]
    store = tmp_path / "m.jsonl"
    _write_store(store, _make_matches(true, rng=rng))
    docs = []
    for tag, main, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.json"
        assert main(["align", str(store), "--model", model, "--solver",
                     solver, "--block-sections", "6", "--out", str(out),
                     *extra]) == 0
        docs.append(json.loads(out.read_text()))
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("aligned 12 sections")
    want, got = docs
    assert got.keys() == want.keys() and got["model"] == model
    assert list(got["transforms"]) == list(want["transforms"])
    t_got = np.array(list(got["transforms"].values()))
    t_want = np.array(list(want["transforms"].values()))
    assert np.abs(t_got - t_want).max() <= 1e-3
    assert abs(got["residual_rms_px"] - want["residual_rms_px"]) <= 1e-3
    off = t_got[:, :, 2] - t_got[0, :, 2]
    assert np.abs(off - true).max() < 0.3


def test_cli_style2_writes_the_same_files(tmp_path, capsys):
    """A style-2 job file through both CLIs: the same TIFF names, outputs
    within 0.05 gray levels, and the port's done line counts no kernel
    launch on the CPU."""
    from optflow_tpu.cli.main import main as jmain
    from optflow_tpu.core.imgio import read_float_tiff
    from optflow_tpu_torch.cli.main import main as tmain

    paths = _drifting_stack(tmp_path)
    for tag in ("jax", "port"):
        (tmp_path / tag).mkdir()
        with gzip.open(tmp_path / f"{tag}.json.gz", "wt") as f:
            json.dump(_style2_job(paths, tmp_path / tag), f)
    assert jmain([str(tmp_path / "jax.json.gz")]) == 0
    capsys.readouterr()
    assert tmain([str(tmp_path / "port.json.gz"), "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("done: ") and "'sections': 3" in last
    assert "'tvl1_level_solve': 0" in last
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["3.tiff", "4.tiff", "5.tiff"]
    for n in names:
        a = read_float_tiff(str(tmp_path / "port" / n))
        b = read_float_tiff(str(tmp_path / "jax" / n))
        assert np.abs(a - b).max() <= 0.05


def test_end_to_end_gen_solve_convert_align(tmp_path):
    """The production loop through the port alone (tests/test_tools.py's
    case): pair graph -> job files -> solve (random_points) -> global
    translation alignment recovering a drift of 2 px a section. Run under
    ``debug``, so the sampling is seeded and the run repeats exactly."""
    from PIL import Image

    from optflow_tpu_torch.core.config import load_job
    from optflow_tpu_torch.engine.runner import run_job
    from optflow_tpu_torch.sinks.store import JsonlMatchSink
    from optflow_tpu_torch.tools.gen_pairs import gen_file_list
    from tests.test_tools import _write_cross

    base_im = make_fibsem_like(np.random.default_rng(1234), 64, 96)
    paths = {}
    ys, xs = np.mgrid[0:64, 0:96].astype(float)
    for z in range(4):
        im = ndi.map_coordinates(base_im, [ys, xs + 2.0 * z], order=3,
                                 mode="nearest")
        p = tmp_path / f"sec{z}.png"
        Image.fromarray(im.astype(np.uint8)).save(str(p))
        paths[f"tile_{z}"] = str(p)

    cross = tmp_path / "cross.json.gz"
    _write_cross(str(cross), n_sections=4, z_dist=2)
    gen_file_list(str(cross), paths, str(tmp_path / "job"), n=12, ppf=100,
                  scale=1.0, output_dir=str(tmp_path), debug=True,
                  nscales=3, warps=2, iterations=40)
    job = load_job(str(tmp_path / "job_0.json.gz"))
    assert job["debug"] is True
    job["match_sink"] = "jsonl"
    job["match_output"] = str(tmp_path / "matches.jsonl")
    stats = run_job(job, device="cpu")
    assert stats["pairs"] == 5  # z-dist <= 2 graph over 4 sections

    recs = JsonlMatchSink(str(tmp_path / "matches.jsonl")).read_all()
    assert len(recs) == 5
    res = tgs.solve_translation_alignment(recs, device="cpu")
    t = res.transforms[:, 0, 2] - res.transforms[0, 0, 2]
    drift = np.diff(t)
    assert np.all(np.abs(np.abs(drift) - 2.0) < 0.6), drift
    assert res.residual < 1.0
    zb = tzb.solve_zblock_alignment(recs, model="translation", device="cpu")
    assert np.abs(zb.transforms - res.transforms).max() <= 1e-2


def test_cuda_paths_never_fall_back(tmp_path):
    """The style-2 job and the alignment solves asked for the card raise
    where there is none, rather than run on the CPU."""
    if torch.cuda.is_available():
        return  # on a card the same calls run there
    recs = _make_matches(_offsets(1, 4, 2), n_pts=3)
    for call in (
        lambda: taf.average_flow_job(_style2_job(_drifting_stack(tmp_path),
                                                 tmp_path)),
        lambda: tgs.solve_translation_alignment(recs),
        lambda: tgs.solve_affine_alignment(recs),
        lambda: tzb.solve_zblock_alignment(recs),
    ):
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    assert not list(tmp_path.glob("*.tiff"))


@pytest.mark.gpu
def test_exact_pyramid_matches_the_plain_solver_on_the_card():
    """tvl1_flow_batched_cuda (the level kernel at every level) against the
    plain solver on the card, at a size whose finest level the JAX
    package's TPU route gives its blocked kernel: within 0.01 px with equal
    iteration counts at every level, ten launches of the level kernel, none
    of the blocked kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1 import (
        get_last_iteration_stats,
        level_solve_plain,
        solve_pyramid,
    )
    from optflow_tpu_torch.ops.tvl1_blocked_cuda import (
        tvl1_blocked_level_solve,
    )
    from optflow_tpu_torch.ops.tvl1_cuda import (
        tvl1_flow_batched_cuda,
        tvl1_level_solve,
    )

    rng = np.random.default_rng(3)
    h, w = 512, 1024
    im0 = make_fibsem_like(rng, h, w)
    im1 = ndi.shift(im0, (0.6, -1.1), order=3, mode="nearest")
    i0 = torch.from_numpy(im0)[None].cuda()
    i1 = torch.from_numpy(im1.astype(np.float32))[None].cuda()
    params = TVL1Params()
    before = (tvl1_level_solve.launches, tvl1_blocked_level_solve.launches)
    got = tvl1_flow_batched_cuda(i0, i1, params)
    got_iters = [it.tolist() for _, it in get_last_iteration_stats()]
    assert (tvl1_level_solve.launches - before[0],
            tvl1_blocked_level_solve.launches - before[1]) == (10, 0)
    want = solve_pyramid(i0, i1, params, None, level_solve_plain)
    assert float((got - want).abs().max()) <= 1e-2
    assert got_iters == [it.tolist() for _, it in get_last_iteration_stats()]


@pytest.mark.gpu
def test_schur_solve_on_the_card_matches_the_cpu(monkeypatch):
    """The z-block factorisations and solves on the card against the same
    system on the CPU, both float64: within 1e-9 of the solution's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(3)
    recs = _make_affine_matches(_small_affines(rng, 30), rng=rng, z_dist=3)
    seen = {}

    def grab(*system):
        seen["system"] = system[:5]
        return tzb_schur(*system)

    tzb_schur = tzb._schur_solve
    monkeypatch.setattr(tzb, "_schur_solve", grab)
    tzb.solve_zblock_alignment(recs, block_sections=10, device="cpu")
    cpu = tzb_schur(*seen["system"], device="cpu")
    card = tzb_schur(*seen["system"], device="cuda")
    for a, b in zip(card, cpu):
        assert a.dtype == np.float64
        assert np.abs(a - b).max() <= 1e-9 * max(np.abs(b).max(), 1.0)
