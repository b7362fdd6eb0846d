"""Sweep the ablation kernel's geometry on one card.

    python3 ablate_sweep.py [CONFIG ...]

A CONFIG is ``rows,warps,halo[,scalar]``: the rows a thread owns (``RUN``),
the warps a block stacks (``WARPS``), the iterations a launch and halo
(``ABLATE_K``) of ``csrc/tvl1_ablate.cu``, and ``scalar`` to turn its 16-byte
copies off (the four-byte path that an image whose width is not a multiple
of 4 takes, and every halo that is not a multiple of 4). Default: the built
geometry and the neighbours it was chosen from.

For each config the tool copies the package and ``chip_smoke.py`` into a
temporary directory, sets those constants in the copy's source and in its
wrapper's mirror of them, builds the copies' ablation and chunk libraries
(one ``nvcc`` each, all at once), then, one config at a time, runs
``chip_smoke.py``'s ablation check (every variant against its plain version,
``full`` against the chunk kernel bit for bit) and the ablation tool at its
defaults, and prints one JSON line: the config, the compiler's register and
spill lines, the check's numbers and the six slopes in microseconds per
iteration. Needs a card; the copies are removed at the end.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
from typing import List, Tuple

from optflow_tpu_torch.tools.kernel_ablate import card_name_and_limit

ROOT = pathlib.Path(__file__).resolve().parent
DEFAULT_CONFIGS = ("4,24,4", "4,24,4,scalar", "3,32,4", "6,16,4", "4,24,3",
                   "4,24,6")

CHECK = """
import json, chip_smoke as c
case = c.kernels_ablate()
print("CHECK " + json.dumps({k: case[k] for k in (
    "kernel_ms", "max_abs_du", "max_abs_vs_chunk_kernel",
    "max_abs_vs_chunk_kernel_m50", "errs_rel_vs_chunk_kernel",
    "rerun_bit_identical")}))
"""


def parse(config: str) -> Tuple[int, int, int, bool]:
    parts = config.split(",")
    rows, warps, halo = (int(p) for p in parts[:3])
    scalar = parts[3:] == ["scalar"]
    if len(parts) not in (3, 4) or (len(parts) == 4 and not scalar):
        raise ValueError(f"a config is rows,warps,halo[,scalar]: {config!r}")
    return rows, warps, halo, scalar


def patch(tree: pathlib.Path, rows: int, warps: int, halo: int,
          scalar: bool) -> None:
    """Set the constants in ``tree``'s copy of the source and the wrapper's
    mirror of the geometry."""
    cu = tree / "optflow_tpu_torch" / "csrc" / "tvl1_ablate.cu"
    text = cu.read_text()
    for name, value in (("RUN", rows), ("WARPS", warps), ("ABLATE_K", halo)):
        text, hits = re.subn(rf"^constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", text,
                             flags=re.M)
        assert hits == 1, name
    if scalar:
        text, hits = re.subn(r"const bool vec = ", "const bool vec = false && ",
                             text)
        assert hits == 1
    cu.write_text(text)
    py = tree / "optflow_tpu_torch" / "ops" / "tvl1_ablate_cuda.py"
    text = py.read_text()
    for pattern, line in (
            (r"^ABLATE_K = \d+$", f"ABLATE_K = {halo}"),
            (r"^TILE_H, TILE_W = \d+, \d+$",
             f"TILE_H, TILE_W = {rows * warps - 2 * halo}, {32 - 2 * halo}")):
        text, hits = re.subn(pattern, line, text, flags=re.M)
        assert hits == 1, pattern
    py.write_text(text)


def run(cmd: List[str], cwd: pathlib.Path) -> str:
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} in {cwd} exited "
                           f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return proc.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Build and time the ablation kernel at several "
        "geometries (rows,warps,halo[,scalar]).")
    ap.add_argument("configs", nargs="*", default=list(DEFAULT_CONFIGS))
    ns = ap.parse_args(argv)
    configs = [parse(c) for c in ns.configs]
    print(json.dumps({"card": card_name_and_limit()}), flush=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="ablate_sweep_"))
    try:
        trees = []
        for i, cfg in enumerate(configs):
            tree = work / f"cfg{i}"
            shutil.copytree(ROOT / "optflow_tpu_torch",
                            tree / "optflow_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
            patch(tree, *cfg)
            trees.append(tree)
        build = ("from optflow_tpu_torch.ops import _build; "
                 "_build.build_libraries(['tvl1_ablate', 'tvl1_chunk'])")
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=tree,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for tree in trees]
        logs = [p.communicate()[0] for p in procs]
        for cfg, tree, proc, log in zip(configs, trees, procs, logs):
            rows, warps, halo, scalar = cfg
            # the kernel takes 16-byte copies only where a window's first
            # column is 16-byte aligned: a halo that is a multiple of 4
            wide = not scalar and halo % 4 == 0
            record = {"rows": rows, "warps": warps, "halo": halo,
                      "copies": "16 B" if wide else "4 B"}
            if proc.returncode != 0:
                record["build_failed"] = log[-3000:]
                print(json.dumps(record), flush=True)
                continue
            lib_logs = sorted((tree / "build" / "optflow_tpu_torch").glob(
                "libtvl1_ablate_*.log"))
            record["ptxas"] = sorted({
                ln.strip() for ln in lib_logs[0].read_text().splitlines()
                if "registers" in ln or "spill" in ln})
            out = run([sys.executable, "-c", CHECK], tree)
            record["check"] = json.loads(
                [ln for ln in out.splitlines() if ln.startswith("CHECK ")][-1]
                [len("CHECK "):])
            out = run([sys.executable, "-m",
                       "optflow_tpu_torch.tools.kernel_ablate"], tree)
            record["slope_us_per_iter"] = {
                m.group(1): float(m.group(2)) for m in re.finditer(
                    r"^(\w+)\s+t\(.*slope=\s*([\d.]+)us/iter", out, re.M)}
            record["t50_ms"] = {
                m.group(1): float(m.group(2)) for m in re.finditer(
                    r"^(\w+)\s+t\(50\)=\s*([\d.]+)ms", out, re.M)}
            print(json.dumps(record), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
