"""The port's benches (``optflow_tpu_torch/bench/``) against the repository's
root benches on the CPU: their inputs bit for bit, the headline solve's
pipeline against the JAX package's solver, the one work count, and each
bench's line (the root line's keys, its gates) at ``--quick`` sizes."""

import dataclasses
import json

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench as jbench
import bench_job as jbench_job
import bench_matrix as jbench_matrix
from optflow_tpu.core.config import TVL1Params as JaxParams
from optflow_tpu.ops import tvl1 as jtv
from optflow_tpu_torch import convert
from optflow_tpu_torch.bench import (
    job,
    matrix,
    roofline,
    scaling,
    section,
    solve,
    synth,
)
from optflow_tpu_torch.core.config import TVL1Params
from optflow_tpu_torch.ops import tvl1 as ttv
from optflow_tpu_torch.ops.pyramid import pyramid_shapes
from optflow_tpu_torch.tools.probes import (
    r4_budget,
    r4_feature_stages,
    r5_sample_stage,
    r5_transfer_cost,
)
from tests.test_torch_blocked import _jax_counted_level

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

QUICK_SRC_H, QUICK_SRC_W, QUICK_STRIP, QUICK_PAIRS = 128, 256, 32, 12


@pytest.mark.parametrize("seed", [0, 3, 15])
@pytest.mark.parametrize("shape", [(48, 128), (70, 96)])
def test_make_pair_equals_the_root_bench(seed, shape):
    got = synth.make_pair(*shape, synth.DX, synth.DY, seed=seed)
    want = jbench.make_pair(*shape, jbench.DX, jbench.DY, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        assert np.array_equal(g, w)


def test_constants_and_oracle_equal_the_root_benches(tmp_path):
    assert (synth.H, synth.W, synth.BATCH, synth.DX, synth.DY) == (
        jbench.H, jbench.W, jbench.BATCH, jbench.DX, jbench.DY)
    assert (synth.SRC_H, synth.SRC_W, synth.SCALE, synth.STRIP,
            synth.DX_STEP, synth.DY_STEP, synth.MAX_DZ) == (
        jbench_job.SRC_H, jbench_job.SRC_W, jbench_job.SCALE,
        jbench_job.STRIP, jbench_job.DX_STEP, jbench_job.DY_STEP,
        jbench_job.MAX_DZ)
    assert np.array_equal(synth.oracle_flow(), jbench._oracle_flow())
    # a fixture of another pair is refused, not skipped
    other = dict(np.load(synth.ORACLE_FIXTURE), seed=np.int64(1))
    np.savez(tmp_path / "other.npz", **other)
    with pytest.raises(ValueError, match="oracle flow"):
        synth.oracle_flow(tmp_path / "other.npz")


@pytest.mark.parametrize("misalign", [True, False])
def test_affine_pairs_equal_the_matrix_benchs_pairs(misalign):
    got = synth.affine_pairs(3, 64, 128, seed0=2, misalign=misalign)
    want = jbench_matrix._pairs(3, 64, 128, seed0=2, misalign=misalign)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)


class _Captured(Exception):
    pass


def test_chained_frames_equal_the_matrix_benchs(monkeypatch):
    """``bench_matrix.bench_features_chained`` hands its frames to
    ``jnp.asarray`` first: caught there, before any solve."""
    def capture(x, *a, **k):
        raise _Captured(np.asarray(x))

    monkeypatch.setattr(jax.numpy, "asarray", capture)
    with pytest.raises(_Captured) as caught:
        jbench_matrix.bench_features_chained(None)
    want = caught.value.args[0]
    got = synth.chained_frames(16, 256, 1024)
    assert want.shape == got.shape == (17, 256, 1024)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_stack_job_sink_and_gate_equal_the_job_bench(monkeypatch, tmp_path):
    """At the ``--quick`` geometry: the decoded PNG sections, the job dict,
    the sink's serialisation and the match gate. The root script sets its
    module's geometry for ``--quick`` the same way."""
    monkeypatch.setattr(jbench_job, "SRC_H", QUICK_SRC_H)
    monkeypatch.setattr(jbench_job, "SRC_W", QUICK_SRC_W)
    monkeypatch.setattr(jbench_job, "STRIP", QUICK_STRIP)
    monkeypatch.setattr(jbench_job, "CACHE_TAG", "q1")
    monkeypatch.setenv("OPTFLOW_TPU_BENCH_STACK", str(tmp_path / "jax"))
    n_frames = QUICK_PAIRS // synth.MAX_DZ + synth.MAX_DZ + 1
    jdir = jbench_job.gen_stack(n_frames)
    tdir = synth.gen_stack(n_frames, QUICK_SRC_H, QUICK_SRC_W,
                           root=str(tmp_path / "torch"))
    sections = synth.gen_sections(n_frames, QUICK_SRC_H, QUICK_SRC_W)
    names = synth.stack_names(tdir, n_frames)
    for z, name in enumerate(names):
        mine = cv2.imread(name, cv2.IMREAD_UNCHANGED)
        theirs = cv2.imread(str(jdir / f"sec_{z:04d}.png"),
                            cv2.IMREAD_UNCHANGED)
        assert mine.shape == (QUICK_SRC_H, QUICK_SRC_W)
        assert np.array_equal(mine, theirs)
        assert np.array_equal(mine, sections[z])
    # a second call finds the cached stack
    assert synth.gen_stack(n_frames, QUICK_SRC_H, QUICK_SRC_W,
                           root=str(tmp_path / "torch")) == tdir

    want = jbench_job.build_job(jdir, n_frames, QUICK_PAIRS, "j.jsonl", "job")
    got = synth.build_job(synth.stack_names(jdir, n_frames), QUICK_PAIRS,
                          "j.jsonl", "job", QUICK_STRIP)
    assert got == want
    assert len(got["images"]) == QUICK_PAIRS

    rng = np.random.default_rng(5)

    def match_set(im, k, err):
        p = rng.uniform(0, 500, (2, k))
        shift = np.array([[im["dz"] * synth.DX_STEP],
                          [im["dz"] * synth.DY_STEP]])
        q = p + shift + rng.normal(0, err, (2, k))
        return {"pId": im["pId"], "qId": im["qId"],
                "matches": {"p": p.tolist(), "q": q.tolist(),
                            "w": [1.0] * k}}

    images = got["images"]
    batch = [match_set(im, 25, 0.3) for im in images[:6]]
    batch.append({"pId": images[6]["pId"], "qId": images[6]["qId"],
                  "matches": {"p": [[], []], "q": [[], []], "w": []}})
    zero = match_set(images[7], 3, 5.0)
    zero["matches"]["w"] = [0.0] * 3
    batch.append(zero)
    batch.append(dict(match_set(images[8], 4, 9.0), pId="tile_x"))
    mine, theirs = synth.MockRenderSink(), jbench_job.MockRenderSink()
    for sink in (mine, theirs):
        sink.put(batch[:5])
        sink.put(batch[5:])
    assert (mine.puts, mine.bytes, mine.match_sets) == (
        theirs.puts, theirs.bytes, theirs.match_sets)
    gate = synth.gate_matches(mine, got)
    assert gate == jbench_job.gate_matches(theirs, want)
    assert gate["match_ok"] and gate["match_err_px"] > 0.1
    assert synth.match_errors(mine.match_sets, got)[1] == 6 * 25
    far = synth.MockRenderSink()
    far.put([match_set(images[0], 10, 3.0)])
    assert synth.gate_matches(far, got) == jbench_job.gate_matches(far, want)
    assert not synth.gate_matches(far, got)["match_ok"]
    empty = synth.MockRenderSink()
    assert synth.gate_matches(empty, got) == jbench_job.gate_matches(
        empty, want) == {"match_err_px": None, "match_ok": False}


def jax_level_counts(i0, i1, jp):
    """Per level, coarsest first, the iterations each image of ``(N, H, W)``
    numpy frames ran in the JAX package's solve (a counted copy of its jnp
    level loop, image by image)."""
    jax_counts = []
    for k in range(len(i0)):
        counts = []

        def counted(a, b, u1, u2, p, u3=None):
            u1, u2, u3, total = _jax_counted_level(a, b, u1, u2, u3, p)
            counts.append(int(total))
            return u1, u2, u3

        jtv.tvl1_flow(jnp.asarray(i0[k]), jnp.asarray(i1[k]), jp,
                      level_solver=counted)
        jax_counts.append(counts)
    return [list(c) for c in zip(*jax_counts)]


def test_solve_pipeline_equals_the_jax_packages_solver():
    """The headline solve's pipeline at ``--quick`` size, (2, 48, 128) with
    3 scales at the other reference defaults, against the JAX package's
    ``tvl1_flow_batched`` off the TPU (the vmapped jnp solver): within 1e-4
    px, every level's count of every image equal to the jnp loop's."""
    i0, i1 = solve.solve_inputs(2, 48, 128)
    jp = JaxParams(nscales=3)
    tp = convert.params_from_reference(dataclasses.asdict(jp))
    got = ttv.tvl1_flow_batched(torch.from_numpy(i0), torch.from_numpy(i1),
                                tp).numpy()
    stats = ttv.get_last_iteration_stats()
    want = np.asarray(jtv.tvl1_flow_batched(jnp.asarray(i0),
                                            jnp.asarray(i1), jp))
    assert np.abs(got - want).max() <= 1e-4

    jax_counts = list(zip(*jax_level_counts(i0, i1, jp)))
    assert [it.tolist() for _, it in stats] == [list(c) for c in
                                                zip(*jax_counts)]
    assert all(0 < c < 5 * 300 for c in np.ravel(jax_counts))  # exits fired
    # the bench's count is the sum of these
    work = roofline.pyramid_work(stats, tp.warps)
    assert work.px_iterations == sum(
        h * w * sum(c) for ((h, w), _), c in zip(stats, zip(*jax_counts)))


@pytest.mark.parametrize("shape", section.QUICK_SHAPES)
def test_section_levels_equal_the_jax_packages_solver(shape):
    """``bench.section``'s timed solve, each level through the level
    kernel's wrapper (its plain version on the CPU), at its ``--quick``
    shapes and 3 scales against the JAX package's ``tvl1_flow_batched``:
    within 1e-4 px, and every level's row counting what the jnp loop counts,
    image by image."""
    n, h, w = shape
    i0, i1 = solve.solve_inputs(n, h, w)
    jp = JaxParams(nscales=3)
    tp = convert.params_from_reference(dataclasses.asdict(jp))
    flow, rows = section.level_rows(torch.from_numpy(i0),
                                    torch.from_numpy(i1), tp)
    stats = ttv.get_last_iteration_stats()
    want = np.asarray(jtv.tvl1_flow_batched(jnp.asarray(i0),
                                            jnp.asarray(i1), jp))
    assert np.abs(flow.numpy() - want).max() <= 1e-4
    counts = jax_level_counts(i0, i1, jp)
    assert [it.tolist() for _, it in stats] == counts
    assert [r["iters_counted"] for r in rows] == [sum(c) for c in counts]
    assert [r["shape"] for r in rows] == [[n, *s] for s, _ in stats]
    assert sum(r["share"] for r in rows) == pytest.approx(1.0)


def test_the_section_line_counts_what_its_levels_count(capsys):
    """The line's counted work is ``pyramid_work``'s of the solve, and its
    levels' counts sum to the solve's (``get_last_iteration_stats``, left
    by the timed levels' solve)."""
    rec = _run_main(capsys, section.main,
                    ["--device", "cpu", "--quick", "2x64x128"])
    sec, = rec["sections"]
    stats = ttv.get_last_iteration_stats()
    assert sec["shape"] == [2, 64, 128] and rec["value"] == sec[
        "mp_pairs_per_s"]
    assert sec["gpx_iters_per_batch"] == roofline.pyramid_work(
        stats, 5).px_iterations / 1e9
    assert [r["iters_counted"] for r in sec["levels"]] == [
        int(it.sum()) for _, it in stats]
    assert sum(r["iters_counted"] for r in sec["levels"]) == sum(
        int(it.sum()) for _, it in stats)


def test_pyramid_work_is_the_hand_count_and_a_share_above_one_raises():
    stats = [((2, 3), torch.tensor([4, 5], dtype=torch.int32)),
             ((4, 6), torch.tensor([1, 2], dtype=torch.int32))]
    work = roofline.pyramid_work(stats, warps=2)
    # level 2x3: 6 px x (63 x 9 iterations + 2 images x (73 x 2 + 4))
    # level 4x6: 24 px x (63 x 3 + 2 x 150)
    assert work.flops == 6 * (63 * 9 + 2 * 150) + 24 * (63 * 3 + 2 * 150)
    assert work.flops == 16938
    assert work.bytes == 16 * 2 * 24  # i0, i1 read, flow written, finest
    assert work.px_iterations == 6 * 9 + 24 * 3
    assert (roofline.ITER_FLOPS_PER_PX, roofline.WARP_FLOPS_PER_PX,
            roofline.GRAD_FLOPS_PER_PX) == (63, 73, 4)

    ops_bound = roofline.Work(67e12, 3.35e12 / 2, 0.0)  # 1 s, 0.5 s
    assert roofline.bound_seconds(ops_bound) == (1.0, "operations")
    assert roofline.share(ops_bound, 4.0) == (0.25, "operations")
    byte_bound = roofline.Work(0.0, 3.35e12, 0.0)
    assert roofline.share(byte_bound, 2.0) == (0.5, "bytes")
    assert roofline.share(ops_bound, 1.0) == (1.0, "operations")
    with pytest.raises(ValueError, match="share"):
        roofline.share(ops_bound, 0.5)
    # the per-call bounds of the kernels line are the same count
    t, by = roofline.level_bound_ms(32, 256, 1024, 2, 32 * 50)
    assert by == "operations" and t == pytest.approx(
        256 * 1024 * (63 * 1600 + 32 * 150) / 67e12 * 1e3)
    t, by = roofline.chunk_bound_ms(4, 512, 1024, 64, 4 * 8)
    assert by == "bytes" and t == pytest.approx(
        (15 * 4 * 4 * 512 * 1024 + 4 * 4 * 64) / 3.35e12 * 1e3)


# the keys of each root bench's line, and the port's differences
JAX_KEYS = {
    # bench.py:262-293
    "solve": {"metric", "value", "unit", "vs_baseline", "epe_px",
              "epe_target_px", "epe_ok", "epe_vs_oracle_px", "oracle_epe_ok",
              "platform", "kernel", "shape", "seconds_per_batch",
              "latency_s_per_batch", "mfu", "gpx_iters_per_batch",
              "shift_warp_fallback_sweeps"},
    # bench_job.py:235-255, with gate_matches's two
    "job": {"metric", "value", "unit", "vs_baseline", "platform", "pairs",
            "pairs_per_s", "wall_s", "mp_per_pair", "stage_breakdown_s",
            "batched", "sequential", "uploads", "matches", "sink_bytes",
            "match_err_px", "match_ok"},
    # bench_matrix.py:190-204
    "features": {"metric", "value", "unit", "vs_baseline", "platform",
                 "seconds_per_batch", "latency_s_per_batch",
                 "good_matches_total", "warp_clamped_px", "e2e_epe_px",
                 "e2e_ok", "affine_corner_err_px", "shape"},
    # bench_matrix.py:270-280
    "features_chained": {"metric", "value", "unit", "vs_baseline",
                         "platform", "seconds_per_batch",
                         "good_matches_total", "unique_frames", "shape"},
    # bench_matrix.py:300-358 (bench_roofline)
    "roofline": {"metric", "platform", "px_iterations", "xla",
                 "pallas_legacy", "pallas_fused", "fused_speedup_vs_xla",
                 "value", "unit", "vs_baseline"},
    # bench_matrix.py:392-401
    "tiled": {"metric", "value", "unit", "vs_baseline", "platform",
              "halo_rows", "seconds", "shape"},
    # bench_scaling.py:193-218
    "scaling": {"metric", "value", "unit", "vs_baseline", "platform",
                "devices", "pairs_per_s", "efficiency",
                "eager_dispatch_enqueue_ms",
                "eager_dispatch_enqueue_sequential_ms",
                "scaling_projection", "note"},
}
RENAMED = {"roofline": {"xla": "plain", "pallas_legacy": "chunk",
                        "pallas_fused": "level",
                        "fused_speedup_vs_xla": "level_speedup_vs_plain"}}
OMITTED = {"solve": {"shift_warp_fallback_sweeps"},
           "features": {"warp_clamped_px"}}
ADDED = {"solve": {"device", "bound"}, "job": {"device", "prefetch"},
         "features_chained": {"device", "e2e_epe_px", "e2e_ok"},
         # the root's xla row is one compiled program: the port's plain row
         # is the plain solve captured as one CUDA graph, its eager call
         # kept as a row of its own
         "roofline": {"device", "plain_eager", "speedup_over",
                      "plain_graph_vs_eager_max_abs_px",
                      "plain_graph_gate_px"}}


# the lines of the port's section bench and probes: the root probes print
# text, so these have no root line to follow
PORT_KEYS = {
    "section": {"metric", "value", "unit", "vs_baseline", "platform",
                "kernel", "device", "clock", "epe_target_px", "epe_ok",
                "sections"},
    "r4_budget": {"probe", "platform", "device", "shape",
                  "full_mp_pairs_per_s", "pyramid_share",
                  "no_iteration_share", "rows"},
    "r4_feature_stages": {"probe", "platform", "device", "shape", "rows",
                          "prealign_mp_pairs_per_s",
                          "combined_mp_pairs_per_s", "good_matches",
                          "composed_vs_prealign_corner_px",
                          "composed_gate_px", "gate_ok"},
    "r5_sample_stage": {"probe", "platform", "device", "frames", "pairs",
                        "strips", "npoints", "rows", "pieces_ms",
                        "mp_pairs_per_s", "pieces_equal_whole"},
    "r5_transfer_cost": {"probe", "platform", "device", "copies", "overlap",
                         "readback_equal"},
}
TIMED_KEYS = {"device_ms", "wall_ms", "enqueue_ms"}


def _run_main(capsys, main, argv):
    assert main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _expected_keys(name):
    if name in PORT_KEYS:
        return PORT_KEYS[name]
    keys = {RENAMED.get(name, {}).get(k, k) for k in JAX_KEYS[name]}
    return (keys - OMITTED.get(name, set())) | ADDED.get(name, {"device"})


CASES = {
    "solve": (solve.main, []),
    "job": (job.main, []),
    "scaling": (scaling.main, ["--virtual", "4"]),
    "features": (matrix.main, ["features"]),
    "features_chained": (matrix.main, ["features_chained"]),
    "roofline": (matrix.main, ["roofline"]),
    "tiled": (matrix.main, ["tiled"]),
    "matrix_scaling": (matrix.main, ["scaling"]),
    "section": (section.main, []),
    "r4_budget": (r4_budget.main, []),
    "r4_feature_stages": (r4_feature_stages.main, []),
    "r5_sample_stage": (r5_sample_stage.main, []),
    "r5_transfer_cost": (r5_transfer_cost.main, []),
}


@pytest.mark.parametrize("name", list(CASES))
def test_bench_prints_one_line_with_the_root_keys_and_its_gates_pass(
        name, capsys, monkeypatch, tmp_path):
    monkeypatch.setenv(synth.STACK_ENV, str(tmp_path))
    main, extra = CASES[name]
    rec = _run_main(capsys, main, ["--device", "cpu", "--quick", *extra])
    key = "scaling" if name == "matrix_scaling" else name
    assert set(rec) == _expected_keys(key)
    assert rec["platform"] == "cpu" and rec["device"].startswith("cpu")
    if key == "solve":
        assert rec["epe_ok"] and rec["shape"] == [2, 48, 128]
        # no oracle at this shape, no share of the card's peak on the CPU
        assert rec["oracle_epe_ok"] is None and rec["mfu"] is None
        assert rec["kernel"] == "plain" and rec["bound"] == "operations"
        assert rec["gpx_iters_per_batch"] > 0
    elif key == "job":
        assert rec["match_ok"] and rec["pairs"] == rec["batched"] == 12
        assert rec["prefetch"] in ("native", "native-resize", "cv2", "pil")
    elif key in ("features", "features_chained"):
        assert rec["e2e_ok"] and rec["good_matches_total"] > 0
    elif key == "roofline":
        for row in ("plain", "plain_eager", "chunk", "level"):
            assert set(rec[row]) == {"seconds_per_image", "px_iter_per_s_G",
                                     "gflops", "share", "bound"}
            assert rec[row]["share"] is None
            assert rec[row]["bound"] == "operations"
    elif key == "tiled":
        assert rec["value"] <= 0.25 and "cpu entered 4 times" in rec["device"]
    elif key == "section":
        assert rec["epe_ok"] and rec["clock"] == "host"
        assert [s["shape"] for s in rec["sections"]] == [
            list(s) for s in section.QUICK_SHAPES]
        for sec in rec["sections"]:
            assert sec["epe_ok"] and sec["mfu"] is None
            assert len(sec["levels"]) == 3
            assert all(lv["iters_computed"] is None for lv in sec["levels"])
    elif key == "r4_budget":
        rows = rec["rows"]
        assert set(rows) == {*r4_budget.SOLVE_ROWS, "pyramid",
                             "tick_pipelined", "tick_synced"}
        for name in r4_budget.SOLVE_ROWS:
            assert TIMED_KEYS < set(rows[name])
            assert rows[name]["device_ms"] is None
        # no exit: every image runs warps x iterations at every level
        eps0 = rows["full_eps0"]
        assert eps0["iters_per_level"] == [[5 * 300] * 2] * 3
        shapes = pyramid_shapes(48, 128, 3, 0.8)
        assert eps0["px_iterations"] == sum(2 * 1500 * h * w
                                            for h, w in shapes)
        assert rows["warps_1_iterations_1"]["iters_per_level"] == [[1, 1]] * 3
        assert rec["no_iteration_share"] == (
            rows["iterations_1"]["wall_ms"] / rows["full"]["wall_ms"])
    elif key == "r4_feature_stages":
        assert rec["gate_ok"] and rec["composed_vs_prealign_corner_px"] == 0.0
        assert list(rec["rows"]) == ["detect_describe", "knn_match",
                                     "ratio_filter", "ransac", "prealign",
                                     "warp", "solve"]
        assert min(rec["good_matches"]) > 10
    elif key == "r5_sample_stage":
        assert rec["pieces_equal_whole"] and rec["strips"] == [8, 32, 128]
        assert list(rec["rows"]) == ["stack_frames", "gather_rois", "solve",
                                     "post_sample", "readback", "whole"]
    elif key == "r5_transfer_cost":
        assert rec["readback_equal"] and rec["overlap"]["streams"] is None
        for row in rec["copies"].values():
            assert row["equal"] and row["h2d_pinned"] is None
            assert TIMED_KEYS < set(row["h2d_pageable"])
    else:
        assert rec["devices"] == 4
        assert set(rec["pairs_per_s"]) == {"1", "2", "4"}
        assert rec["scaling_projection"]["projected_efficiency"] is None


@pytest.mark.parametrize("module", [solve, job, matrix, scaling, section,
                                    r4_budget, r4_feature_stages,
                                    r5_sample_stage, r5_transfer_cost])
def test_without_a_card_a_bench_exits_with_a_message(module, monkeypatch,
                                                     capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ended:
        module.main(["--quick"])
    assert "torch.cuda.is_available() is false" in str(ended.value.code)
    assert capsys.readouterr().out == ""


def test_the_roofline_names_its_divisor_and_keeps_the_eager_row(capsys):
    """On the CPU, which has no CUDA graphs, ``plain`` is the eager call and
    the line says so; ``value`` divides by ``plain``."""
    rec = _run_main(capsys, matrix.main,
                    ["--device", "cpu", "--quick", "roofline"])
    assert rec["speedup_over"].startswith("plain: ")
    assert "eager" in rec["speedup_over"]
    assert rec["plain_graph_vs_eager_max_abs_px"] is None
    assert rec["plain_graph_gate_px"] == matrix.PLAIN_GRAPH_GATE_PX == 0.0
    assert rec["plain_eager"]["seconds_per_image"] > 0
    assert rec["value"] == rec["level_speedup_vs_plain"] == (
        rec["plain"]["seconds_per_image"] / rec["level"]["seconds_per_image"])


def test_a_launch_count_returns_once_the_card_has_run_the_call(monkeypatch):
    """``chip_smoke.enqueued_launches`` synchronises with the card after the
    call, so a timer started next does not time the call's tail; the count
    is still what the call enqueued."""
    import chip_smoke
    from optflow_tpu_torch.ops import _build

    tally, events = [5, 0], []

    def enqueued():
        events.append("read")
        return tuple(tally)

    def fn():
        events.append("call")
        tally[0] += 3

    monkeypatch.setattr(_build, "enqueued", enqueued)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: events.append("synchronize"))
    assert chip_smoke.enqueued_launches(fn) == (3, 0)
    assert events == ["read", "call", "synchronize", "read"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_captured_plain_roofline_row_equals_the_eager_call(cuda, capsys):
    rec = _run_main(capsys, matrix.main, ["--quick", "roofline"])
    assert "CUDA graph" in rec["speedup_over"]
    assert rec["plain_graph_vs_eager_max_abs_px"] <= matrix.PLAIN_GRAPH_GATE_PX
    for row in ("plain", "plain_eager", "chunk", "level"):
        assert 0.0 < rec[row]["share"] <= 1.0


@pytest.mark.gpu
def test_the_level_api_runs_line_up(cuda, capsys):
    """Each of ``chip_smoke``'s three timed runs of the per-level API starts
    on an idle card: the three are within 10 % of one another."""
    import chip_smoke

    chip_smoke.phase_level_api({})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    runs = [line["solve_ms"], *line["solve_ms_two_more_runs"]]
    assert max(runs) <= 1.1 * min(runs), runs


@pytest.mark.gpu
def test_a_section_solve_launches_the_level_kernel_once_a_level(cuda):
    """``bench.section``'s timed solve of a (4, 512, 1024) section on the
    card: the level kernel's wrapper called once a level, the blocked and
    chunk kernels never, and the libraries' own tally one kernel a level."""
    from optflow_tpu_torch.ops import _build
    from optflow_tpu_torch.ops.tvl1_blocked_cuda import (
        tvl1_blocked_level_solve,
    )
    from optflow_tpu_torch.ops.tvl1_chunk_cuda import (
        tvl1_chunk,
        tvl1_chunk_level_solve,
    )
    from optflow_tpu_torch.ops.tvl1_cuda import tvl1_level_solve

    i0, i1 = (torch.from_numpy(a).to(cuda)
              for a in solve.solve_inputs(4, 512, 1024))
    params = TVL1Params()
    section.level_rows(i0, i1, params)  # builds and loads the library
    wrappers = (tvl1_level_solve, tvl1_blocked_level_solve, tvl1_chunk,
                tvl1_chunk_level_solve)
    before = [fn.launches for fn in wrappers]
    kernels = _build.enqueued()[0]
    flow, rows = section.level_rows(i0, i1, params)
    kernels = _build.enqueued()[0] - kernels
    launched = [fn.launches - b for fn, b in zip(wrappers, before)]
    assert launched == [params.nscales, 0, 0, 0]
    assert kernels == len(rows) == params.nscales
    assert all(r["iters_computed"] >= r["iters_counted"] for r in rows)
    assert bool(torch.isfinite(flow).all())
