"""The port's deploy recipe on the CPU: deploy/bootstrap_venv_torch.sh builds
the wheel, installs it into an isolated prefix, checks the console scripts,
builds the image loader from the installed tree and runs a scale-0.5 job
through the installed CLI; the container recipe prebuilds what the image
needs at run time."""

import os
import pathlib
import subprocess
import sys
import zipfile

import pytest
import torch

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = {
    "optflow-torch": "optflow_tpu_torch.cli.main:main",
    "optflow-torch-pod": "optflow_tpu_torch.cli.run_pod:main",
    "optflow-torch-gen-pairs": "optflow_tpu_torch.tools.gen_pairs:main",
    "optflow-torch-upload-matches":
        "optflow_tpu_torch.tools.upload_matches:main",
}


@pytest.fixture(scope="module")
def bootstrap(tmp_path_factory):
    work = tmp_path_factory.mktemp("bootstrap")
    env = dict(os.environ)
    # the script's python3 is this interpreter, and it imports the port from
    # the install only
    env["PATH"] = f"{pathlib.Path(sys.executable).parent}:{env['PATH']}"
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        ["bash", str(ROOT / "deploy" / "bootstrap_venv_torch.sh"), str(work),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env,
    )
    return work, proc


def test_bootstrap_installs_and_runs_a_job_on_the_cpu(bootstrap):
    work, proc = bootstrap
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert "== SMOKE PASSED ==" in out
    for name, target in SCRIPTS.items():
        assert f"{name} -> {target}" in out
    assert "no jax, no optflow_tpu;" in out
    done = [ln for ln in out.splitlines() if ln.startswith("done: ")]
    assert len(done) == 1 and "'decoder': 'native'" in done[0]
    assert "'pairs': 2" in done[0] and "'skipped': 0" in done[0]
    for step in ("wheel", "install", "scripts", "build", "job"):
        assert f"   {step}: " in out
    for stem in ("loader", "frame"):  # the host libraries, from the install
        built = list((work / "install" / "build" / "optflow_tpu_torch").glob(
            f"lib{stem}_*.so"))
        assert len(built) == 1, stem
        assert f"{stem}: {built[0]}" in out
    assert sorted(p.name for p in (work / "out").iterdir()) == [
        f"s{z}_0.50_{c}.tiff" for z in range(2) for c in "xy"]


def test_the_wheel_ships_every_native_source_and_the_port_scripts(bootstrap):
    work, proc = bootstrap
    assert proc.returncode == 0, proc.stderr[-3000:]
    (wheel,) = (work / "dist").glob("optflow_tpu-*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    port = ROOT / "optflow_tpu_torch"
    sources = [*port.glob("csrc/*.cu"), *port.glob("csrc/*.cuh"),
               port / "native" / "loader.cpp", port / "native" / "frame.cpp"]
    assert len(sources) == 9
    for src in sources:
        assert f"optflow_tpu_torch/{src.relative_to(port)}" in names
    (entry,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
    text = zipfile.ZipFile(wheel).read(entry).decode()
    for name, target in SCRIPTS.items():
        assert f"{name} = {target}" in text
    # the JAX package's commands are still there, unchanged
    assert "optflow = optflow_tpu.cli.main:main" in text
    # nothing was written into the repository
    assert not list(ROOT.glob("*.egg-info"))


def test_the_container_recipe_prebuilds_every_library():
    text = (ROOT / "deploy" / "optflow_tpu_torch.def").read_text()
    post = text.split("\n%post\n", 1)[1].split("\n%runscript\n", 1)[0]
    assert "python3 -m optflow_tpu_torch.ops._build" in post
    assert "|| true" not in text and "set -eu" in post
    assert "pip3 install" in post and "--no-deps" in post
    # the torch the port was measured with, from the CUDA 12.8 wheels
    assert ("torch==2.11.0 --index-url https://download.pytorch.org/whl/cu128"
            in post)
    assert "jax" not in post  # the port's image installs no JAX
    for lib in ("libpng-dev", "libjpeg-dev", "libtiff-dev", "g++"):
        assert lib in post
    # builds the header-free resize with the rest (all of them, no stems)
    assert "python3 -m optflow_tpu_torch.ops._build\n" in post
    assert 'exec optflow-torch "$@"' in text.split("\n%runscript\n", 1)[1]
    run_job = (ROOT / "deploy" / "run_job_torch.sh").read_text()
    assert 'python -m optflow_tpu_torch.cli.main "$@"' in run_job
