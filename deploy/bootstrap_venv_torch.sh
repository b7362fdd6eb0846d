#!/usr/bin/env bash
# Clean-environment install + smoke run of the PyTorch/CUDA port: the
# validation layer for its container recipe (optflow_tpu_torch.def). The def
# file's %post installs the system libraries and torch, `pip install`s this
# repo without deps, and prebuilds every kernel, the image loader and its
# header-free resize with `python3 -m optflow_tpu_torch.ops._build`; its %runscript is
# `optflow-torch job.json`. This script performs the same sequence against an
# isolated install prefix and runs a real job through the INSTALLED console
# script (not the source tree), so packaging faults (a source missing from
# the wheel, a broken entry point, a library that does not build from the
# installed tree) surface here.
#
# Network-free: the run-time deps (torch, numpy, scipy, an image library)
# come from the running environment; the repo is built into a wheel and
# installed with --no-deps --no-index, which is the part the recipe must
# prove. No container runtime is needed.
#
# Usage: bash deploy/bootstrap_venv_torch.sh [workdir] [--device cuda|cpu]
#   cuda (default): builds every kernel and the host libraries, runs the
#                   job on the card; cpu: builds the host libraries only (no
#                   nvcc needed) and runs the job's plain versions on the
#                   CPU. The loader is left out, and said so, where its
#                   headers are missing: jobs then decode through the
#                   header-free resize (`frame`), which every build needs.
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
WORK=""
DEVICE="cuda"
while [ $# -gt 0 ]; do
    case "$1" in
        --device) DEVICE="$2"; shift 2 ;;
        --device=*) DEVICE="${1#--device=}"; shift ;;
        -*) echo "unknown option $1" >&2; exit 2 ;;
        *) WORK="$1"; shift ;;
    esac
done
case "$DEVICE" in
    cuda|cpu) ;;
    *) echo "--device must be cuda or cpu, not $DEVICE" >&2; exit 2 ;;
esac
WORK="${WORK:-$(mktemp -d)}"
mkdir -p "$WORK"
WORK="$(cd "$WORK" && pwd)"
PY=python3
echo "== optflow_tpu_torch install smoke ($DEVICE) =="
echo "repo: $REPO  work: $WORK  python: $(command -v $PY)"

# each step ends with a line "   <step>: <seconds> s"
step() { echo "-- [$1] $2"; T0=$EPOCHREALTIME; }
took() { awk -v n="$1" -v a="$T0" -v b="$EPOCHREALTIME" \
    'BEGIN { printf "   %s: %.3f s\n", n, b - a }'; }

step wheel "build the wheel (pyproject, package data)"
# from a copy of the sources: setuptools builds in the source tree and would
# leave build/lib and *.egg-info behind, and a stale build/lib could put a
# deleted file into the wheel
rm -rf "$WORK/src" "$WORK/dist"
mkdir -p "$WORK/src"
cp -r "$REPO/pyproject.toml" "$REPO/README.md" "$REPO/optflow_tpu" \
    "$REPO/optflow_tpu_torch" "$WORK/src/"
$PY -m pip wheel --no-build-isolation --no-deps --no-cache-dir -q \
    -w "$WORK/dist" "$WORK/src"
WHEEL="$(ls "$WORK"/dist/optflow_tpu-*.whl)"
echo "   wheel: $WHEEL"
took wheel

step install "install into an isolated prefix (no network, no deps)"
rm -rf "$WORK/install"
$PY -m pip install --no-index --no-deps --no-cache-dir -q \
    --target "$WORK/install" "$WHEEL"
took install

step scripts "console scripts and the import location"
cd "$WORK"  # keep the repo's source tree off sys.path[0]
PYTHONPATH="$WORK/install" $PY - "$WORK" "$WHEEL" "$REPO" <<'EOF'
import importlib.metadata as md
import pathlib
import sys
import zipfile

work, wheel, repo = sys.argv[1:4]
install = pathlib.Path(work) / "install"
import optflow_tpu_torch

print("   package at", optflow_tpu_torch.__file__)
assert optflow_tpu_torch.__file__.startswith(str(install)), \
    "imported from the source tree, not the install"
# every native source of the port is in the wheel
names = set(zipfile.ZipFile(wheel).namelist())
port = pathlib.Path(repo) / "optflow_tpu_torch"
want = {f"optflow_tpu_torch/{p.relative_to(port)}" for p in
        [*port.glob("csrc/*.cu"), *port.glob("csrc/*.cuh"),
         *port.glob("native/*.cpp")]}
missing = sorted(want - names)
assert not missing, f"the wheel lacks {missing}"
dist = md.distribution("optflow_tpu")
assert str(dist.locate_file("")).startswith(str(install)), dist.locate_file("")
scripts = {e.name: e for e in dist.entry_points
           if e.group == "console_scripts"}
for name, target in (
        ("optflow-torch", "optflow_tpu_torch.cli.main:main"),
        ("optflow-torch-pod", "optflow_tpu_torch.cli.run_pod:main"),
        ("optflow-torch-gen-pairs", "optflow_tpu_torch.tools.gen_pairs:main"),
        ("optflow-torch-upload-matches",
         "optflow_tpu_torch.tools.upload_matches:main")):
    ep = scripts.get(name)
    assert ep is not None and ep.value == target, (name, ep)
    fn = ep.load()
    where = sys.modules[fn.__module__].__file__
    assert where.startswith(str(install)), (name, where)
    assert (install / "bin" / name).exists(), f"no bin/{name}"
    print(f"   {name} -> {target}")
print(f"   {len(want)} native sources in the wheel")
EOF
took scripts

step build "build the libraries from the installed tree"
# into the install prefix's build/, beside the package, never into the repo's
BUILT="$WORK/install/build/optflow_tpu_torch/"
STEMS=""
if [ "$DEVICE" = cuda ]; then  # every kernel: csrc/<stem>.cu
    for cu in "$WORK"/install/optflow_tpu_torch/csrc/*.cu; do
        STEMS="$STEMS $(basename "$cu" .cu)"
    done
fi
# The image loader includes the headers of libpng, libjpeg and libtiff
# (optflow_tpu_torch.def installs them). On a machine without them the port
# decodes with cv2 and the loader's resize (`frame`, which includes no image
# header): this step then names the missing header, and the job's `done:`
# line names the route it used (`native-resize`). Any other failed build
# fails the step.
# shellcheck disable=SC2086  # one argument a library
if ! PYTHONPATH="$WORK/install" $PY -m optflow_tpu_torch.ops._build \
        $STEMS loader frame > "$WORK/built.txt" 2> "$WORK/build.err"; then
    # shellcheck disable=SC2086
    PYTHONPATH="$WORK/install" $PY - "$WORK/build.err" $STEMS <<'EOF_PY'
import sys

from optflow_tpu_torch import native
from optflow_tpu_torch.ops import _build

log, kernels = sys.argv[1], sys.argv[2:]
header = native.missing_header()  # from the failure the build recorded
if header is None or not all(_build.library_path(s).exists()
                             for s in [*kernels, "frame"]):
    sys.exit(open(log).read())
print(f"   loader: not built, this machine lacks {header}")
EOF_PY
fi
cat "$WORK/built.txt"
if grep -v ": $BUILT" "$WORK/built.txt"; then
    echo "a library was built outside $BUILT" >&2
    exit 1
fi
took build

step job "a 2-pair PNG flow job at scale 0.5 through the installed CLI"
$PY - "$WORK" "$DEVICE" <<'EOF'
import json
import os
import sys

import numpy as np
import scipy.ndimage as ndi

work, device = sys.argv[1:3]
# the product's section geometry on the card; a small frame on the CPU,
# where the solver runs its plain version
h, w = (1024, 2048) if device == "cuda" else (128, 256)
os.makedirs(f"{work}/imgs", exist_ok=True)
rng = np.random.default_rng(0)
pad = 8
tex = ndi.gaussian_filter(rng.standard_normal((h + 2 * pad, w + 2 * pad)), 3.0)
tex = 20 + 215 * (tex - tex.min()) / np.ptp(tex)
paths = []
for z in range(3):  # 2 px to the right per section
    im = np.ascontiguousarray(tex[pad:pad + h, pad - 2 * z:pad - 2 * z + w])
    path = f"{work}/imgs/sec_{z}.png"
    try:
        import cv2

        assert cv2.imwrite(path, im.astype(np.uint8))
    except ImportError:
        from PIL import Image

        Image.fromarray(im.astype(np.uint8)).save(path)
    paths.append(path)
job = {
    "style": 1, "scale": 0.5, "output_type": "flow",
    "output_dir": f"{work}/out", "features": False, "pair_batch": 2,
    "rois": {"top": 256, "bottom": 256} if device == "cuda"
    else {"custom": [0, 0, w // 2, h // 2]},
    "images": [{"p": paths[z], "q": paths[z + 1], "output_name": f"s{z}"}
               for z in range(2)],
}
if device == "cpu":
    job.update(nscales=3, warps=2, iterations=20)
with open(f"{work}/job.json", "w") as f:
    json.dump(job, f)
EOF
rm -rf "$WORK/out"
# the console script itself, run in this process so that its modules can be
# read after it
PYTHONPATH="$WORK/install" $PY - "$WORK" "$DEVICE" <<'EOF'
import runpy
import sys

work, device = sys.argv[1:3]
script = f"{work}/install/bin/optflow-torch"
sys.argv = [script, f"{work}/job.json", "--device", device]
try:
    runpy.run_path(script, run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code
if rc not in (0, None):
    raise SystemExit(f"optflow-torch exited with {rc}")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "optflow_tpu"))
if bad:
    raise SystemExit(f"the job imported {bad[:8]}")
mods = [m for m in sys.modules if m.split(".")[0] == "optflow_tpu_torch"]
if not all(getattr(sys.modules[m], "__file__", None) is None
           or sys.modules[m].__file__.startswith(f"{work}/install/")
           for m in mods):
    raise SystemExit("the job imported the port from outside the install")
print(f"   no jax, no optflow_tpu; {len(mods)} modules of the installed port")
# each section is the last moved 2 px right: 1 px at scale 0.5
from optflow_tpu_torch.core.imgio import read_float_tiff

for z in range(2):
    for roi in (("_top", "_bottom") if device == "cuda" else ("",)):
        fx, fy = (read_float_tiff(f"{work}/out/s{z}_0.50{roi}_{c}.tiff")
                  for c in "xy")
        err = float(abs(fx[8:-8, 8:-8] - 1.0).mean()
                    + abs(fy[8:-8, 8:-8]).mean())
        print(f"   s{z}_0.50{roi}: {fx.shape}, mean error {err:.4f} px")
        if not err <= 0.1:
            raise SystemExit(f"s{z}{roi}: the flow is {err} px off its truth")
EOF
took job
echo "== SMOKE PASSED =="
