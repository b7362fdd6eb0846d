"""The port stands alone: it imports torch, never jax, and nothing of the
JAX package; and on the CPU its kernel wrapper takes the plain version."""

import pathlib
import re
import subprocess
import sys

import torch

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import optflow_tpu_torch\n"
        "import optflow_tpu_torch.cli.main\n"
        "import optflow_tpu_torch.engine.batch_runner\n"
        "import optflow_tpu_torch.engine.prefetch\n"
        "import optflow_tpu_torch.ops.tvl1_cuda\n"
        "import optflow_tpu_torch.ops.tvl1_blocked_cuda\n"
        "import optflow_tpu_torch.ops.tvl1_chunk_cuda\n"
        "import optflow_tpu_torch.convert\n"
        "import optflow_tpu_torch.engine.features_glue\n"
        "import optflow_tpu_torch.features\n"
        "import optflow_tpu_torch.features.align\n"
        "import optflow_tpu_torch.features.patches\n"
        "import optflow_tpu_torch.ops.tvl1_ablate_cuda\n"
        "import optflow_tpu_torch.ops.smem_cap_cuda\n"
        "import optflow_tpu_torch.tools.kernel_ablate\n"
        "import optflow_tpu_torch.tools.smem_cap\n"
        "import optflow_tpu_torch.align\n"
        "import optflow_tpu_torch.align.zblock\n"
        "import optflow_tpu_torch.sinks.render_client\n"
        "import optflow_tpu_torch.tools.gen_pairs\n"
        "import optflow_tpu_torch.tools.upload_matches\n"
        "import optflow_tpu_torch.dist\n"
        "import optflow_tpu_torch.dist.mesh\n"
        "import optflow_tpu_torch.dist.scheduler\n"
        "import optflow_tpu_torch.dist.tiled\n"
        "import optflow_tpu_torch.align.distributed\n"
        "import optflow_tpu_torch.cli.run_pod\n"
        "import optflow_tpu_torch.native\n"
        "import optflow_tpu_torch.native.frame\n"
        "import optflow_tpu_torch.ops._build\n"
        "import optflow_tpu_torch.bench.synth\n"
        "import optflow_tpu_torch.bench.roofline\n"
        "import optflow_tpu_torch.bench.solve\n"
        "import optflow_tpu_torch.bench.job\n"
        "import optflow_tpu_torch.bench.matrix\n"
        "import optflow_tpu_torch.bench.scaling\n"
        "import optflow_tpu_torch.bench.section\n"
        "import optflow_tpu_torch.tools.probes.r4_budget\n"
        "import optflow_tpu_torch.tools.probes.r4_feature_stages\n"
        "import optflow_tpu_torch.tools.probes.r5_sample_stage\n"
        "import optflow_tpu_torch.tools.probes.r5_transfer_cost\n"
        # builds (or finds) and loads the port's own loader library
        "assert optflow_tpu_torch.native.available()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'optflow_tpu' or "
        "m.startswith('optflow_tpu.') or m in ('bench', 'bench_job', "
        "'bench_matrix', 'bench_scaling'))\n"
        "late = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('cv2', 'PIL', 'triton'))\n"
        "print('BAD', bad)\n"
        "print('LATE', late)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout
    # image libraries and triton are imported at first use, never at import
    assert "LATE []" in proc.stdout


def test_sources_import_neither_jax_nor_the_jax_package():
    # the JAX package, and the root benches (which import it)
    pattern = re.compile(
        r"^\s*(?:from|import)\s+(jax|optflow_tpu|bench(?:_job|_matrix|"
        r"_scaling)?)(?![\w])", re.MULTILINE
    )
    package = sorted((ROOT / "optflow_tpu_torch").rglob("*.py"))
    # the port's scripts beside the package
    files = package + [ROOT / "chip_smoke.py", ROOT / "compare_trees.py",
                       ROOT / "ablate_sweep.py"]
    assert len(files) > 20
    names = {f.name for f in files}
    assert {"tvl1_blocked_cuda.py", "tvl1_chunk_cuda.py", "prefetch.py"} <= names
    rel = {str(f.relative_to(ROOT / "optflow_tpu_torch")) for f in package}
    assert {"features/align.py", "features/detect.py", "features/patches.py",
            "features/descriptors.py", "features/match.py",
            "features/ransac.py", "engine/features_glue.py",
            "tools/kernel_ablate.py", "tools/smem_cap.py",
            "ops/tvl1_ablate_cuda.py", "ops/smem_cap_cuda.py",
            "align/global_solve.py", "align/zblock.py",
            "align/average_flow.py", "sinks/render_client.py",
            "tools/gen_pairs.py", "tools/upload_matches.py",
            "dist/__init__.py", "dist/mesh.py", "dist/scheduler.py",
            "dist/tiled.py", "align/distributed.py", "cli/run_pod.py",
            "native/__init__.py", "ops/_build.py", "bench/__init__.py",
            "bench/synth.py", "bench/roofline.py", "bench/solve.py",
            "bench/job.py", "bench/matrix.py", "bench/scaling.py",
            "bench/section.py", "tools/probes/r4_budget.py",
            "tools/probes/r4_feature_stages.py",
            "tools/probes/r5_sample_stage.py",
            "tools/probes/r5_transfer_cost.py"} <= rel
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_kernel_sources_are_cuda_sources_of_this_package():
    """Every kernel chip_smoke.py lists is built from a .cu file under the
    package's csrc/, which names the TPU kernel it replaces."""
    csrc = ROOT / "optflow_tpu_torch" / "csrc"
    stems = sorted(f.stem for f in csrc.glob("*.cu"))
    assert stems == ["smem_cap", "tvl1_ablate", "tvl1_blocked", "tvl1_chunk",
                     "tvl1_level"]
    smoke = (ROOT / "chip_smoke.py").read_text()
    # the persistent level grid's header brings the shared device code
    assert '#include "tvl1_common.cuh"' in (csrc / "tvl1_grid.cuh").read_text()
    for stem, body in (("tvl1_blocked", "_make_blocked_kernel"),
                       ("tvl1_chunk", "_make_kernel"),
                       ("tvl1_level", "_make_fused_kernel"),
                       ("tvl1_ablate", "make_kernel"),
                       ("smem_cap", "try_mb")):
        text = (csrc / f"{stem}.cu").read_text()
        assert body in text
        shared = "tvl1_common.cuh" in text or "tvl1_grid.cuh" in text
        assert shared == stem.startswith("tvl1_")
        assert f"optflow_tpu_torch/csrc/{stem}.cu" in smoke
        assert "torch/extension.h" not in text  # plain C interface, ctypes


def test_entry_points_default_to_the_gpu():
    """Entry points run on the card unless the caller asks for the CPU."""
    import inspect

    from optflow_tpu_torch import convert
    from optflow_tpu_torch.align import average_flow, global_solve, zblock
    from optflow_tpu_torch.bench import job, matrix, scaling, solve
    from optflow_tpu_torch.cli import main as cli
    from optflow_tpu_torch.cli import run_pod
    from optflow_tpu_torch.engine import (
        batch_runner,
        features_glue,
        pair,
        runner,
    )
    from optflow_tpu_torch.features import align
    from optflow_tpu_torch.tools import kernel_ablate, smem_cap

    for fn in (batch_runner.run_job_batched, runner.run_job, pair.solve_rois,
               pair.solve_wrapper, convert.level_state_from_numpy,
               convert.flow_from_numpy, convert.canvas_to_tensor,
               convert.keypoints_from_numpy, convert.affine_from_numpy,
               align.find_alignment, features_glue.default_aligner,
               kernel_ablate.run_ablation, smem_cap.run_probe,
               average_flow.average_flow_job,
               global_solve.solve_translation_alignment,
               global_solve.solve_affine_alignment,
               zblock.solve_zblock_alignment):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__name__
    for main in (cli.main, cli._align_main, kernel_ablate.main,
                 smem_cap.main, run_pod.main, solve.main, job.main,
                 matrix.main, scaling.main):
        assert 'default="cuda"' in inspect.getsource(main)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    from optflow_tpu_torch.core.config import TVL1Params
    from optflow_tpu_torch.ops.tvl1 import tvl1_flow_batched
    from optflow_tpu_torch.ops.tvl1_cuda import (
        tvl1_level_solve,
        tvl1_level_solve_plain,
    )

    g = torch.Generator().manual_seed(3)
    i0 = torch.rand(2, 20, 24, generator=g) * 200 + 20
    i1 = torch.roll(i0, 1, dims=2)
    z = torch.zeros_like(i0)
    p = TVL1Params(nscales=2, warps=2, iterations=8)
    before = tvl1_level_solve.launches
    a = tvl1_level_solve(i0, i1, z, z, p)
    b = tvl1_level_solve_plain(i0, i1, z, z, p)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    flow = tvl1_flow_batched(i0, i1, p)
    assert flow.shape == (2, 20, 24, 2) and flow.device.type == "cpu"
    assert tvl1_level_solve.launches == before == 0


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        return  # on a GPU machine the script is run whole instead
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_the_loader_is_the_ports_own_copy():
    """The port compiles its own native/loader.cpp into its build directory:
    it never loads the JAX package's libofloader.so or runs its Makefile."""
    from optflow_tpu_torch import native
    from optflow_tpu_torch.ops import _build

    text = (ROOT / "optflow_tpu_torch" / "native" / "__init__.py").read_text()
    assert "libofloader" not in text and "make" not in text.split()
    assert _build.HOST_SOURCES["loader"] == (
        ROOT / "optflow_tpu_torch" / "native" / "loader.cpp")
    assert native.available(), native.build_error()
    path = _build.library_path("loader")
    assert path.parent == ROOT / "build" / "optflow_tpu_torch"
    assert path.exists()
    # the same C ABI and the same arithmetic as the JAX package's copy
    port = (ROOT / "optflow_tpu_torch" / "native" / "loader.cpp").read_text()
    ref = (ROOT / "optflow_tpu" / "native" / "loader.cpp").read_text()
    body = ref[ref.index("#include <cmath>"):]
    assert port.endswith(body)
