"""Time two checkouts of the repository on one card, in turns.

    python3 compare_trees.py OTHER \\
        [--phases device,build,kernels,ablate] [--log-dir DIR]

Runs ``python3 chip_smoke.py --phases PHASES`` from the root of OTHER (an
older tree, for example a ``git archive`` of the parent commit unpacked in a
directory that git ignores) and from the root of this checkout, in the
order other, this, this, other, each in a process of its own on the same
card. Each tree builds its own kernels in its own ``build/`` (the first run
of a tree compiles them, the second reuses them).

Prints one JSON line: the card's name and power limit; per kernel of the
``kernels`` line its ``ms`` (and ``call_ms`` where the row has one) in each
of the four runs and the mean of each tree's two; per variant of the
``ablate`` phase its slope in microseconds per iteration, the same way.
Needs a card; any run that fails ends the comparison with its output.

``--sass STEM[,STEM...]`` compares machine code instead: it builds those
libraries in both trees and prints, per library, whether ``cuobjdump -sass``
gives the same instructions (the compiler's per-file names of the anonymous
namespace aside) and how many each has.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
from typing import Dict, List

from optflow_tpu_torch.tools.kernel_ablate import card_name_and_limit

THIS = pathlib.Path(__file__).resolve().parent


def run_smoke(tree: pathlib.Path, phases: str, log: pathlib.Path = None
              ) -> Dict[str, dict]:
    """One ``chip_smoke.py`` run from ``tree``'s root: ``{"kernels": {name:
    row}, "ablate": phase line or None}``."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", phases], cwd=tree,
        capture_output=True, text=True,
    )
    if log is not None:
        log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"chip_smoke.py in {tree} exited "
                           f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    found = {"kernels": {}, "ablate": None}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        if "kernels" in obj:
            found["kernels"] = {row["name"]: row for row in obj["kernels"]}
        elif obj.get("phase") == "ablate":
            found["ablate"] = obj
    return found


def in_turns(runs: List[Dict[str, dict]]) -> dict:
    """The four runs (other, this, this, other) side by side: per kernel and
    per ablation variant the four values and each tree's mean."""

    def pair(values):
        return {"runs": values, "other": (values[0] + values[3]) / 2,
                "this": (values[1] + values[2]) / 2}

    out = {"kernels": {}, "ablate_slope_us_per_iter": {}}
    for name in runs[1]["kernels"]:
        rows = [r["kernels"].get(name) for r in runs]
        if any(row is None for row in rows):
            continue
        entry = {"ms": pair([row["ms"] for row in rows])}
        if all("call_ms" in row for row in rows[1:3]):
            entry["this_call_ms"] = [row["call_ms"] for row in rows[1:3]]
        out["kernels"][name] = entry
    if all(r["ablate"] is not None for r in runs):
        for name in runs[1]["ablate"]["slope_us_per_iter"]:
            out["ablate_slope_us_per_iter"][name] = pair(
                [r["ablate"]["slope_us_per_iter"][name] for r in runs])
    return out


def sass(tree: pathlib.Path, stem: str) -> List[str]:
    """The instructions of ``tree``'s built library ``stem``, as
    ``cuobjdump -sass`` lists them, with the per-file hash of the anonymous
    namespace's names taken out."""
    libs = sorted((tree / "build" / "optflow_tpu_torch").glob(
        f"lib{stem}_*.so"), key=lambda f: f.stat().st_mtime)
    if not libs:
        raise RuntimeError(f"no built lib{stem} in {tree}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(libs[-1])], capture_output=True,
                         text=True, check=True).stdout
    lines = []
    for line in out.splitlines():
        line = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "ANON",
                      line.strip())
        if line.startswith(("Function :", "/*")):
            lines.append(line)
    return lines


def compare_sass(other: pathlib.Path, stems: List[str]) -> dict:
    """Build ``stems`` in both trees and compare their machine code."""
    build = ("from optflow_tpu_torch.ops import _build; "
             f"_build.build_libraries({stems!r})")
    for tree in (other, THIS):
        subprocess.run([sys.executable, "-c", build], cwd=tree, check=True)
    out = {}
    for stem in stems:
        a, b = sass(other, stem), sass(THIS, stem)
        count = sum(1 for ln in b if re.match(r"/\*[0-9a-f]{4,}\*/", ln))
        out[stem] = {"same_sass": a == b, "instructions": count,
                     "lines_other": len(a), "lines_this": len(b)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Time chip_smoke.py's kernels in two checkouts, in "
        "turns (other, this, this, other).")
    ap.add_argument("other", type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--phases", default="device,build,kernels,ablate")
    ap.add_argument("--log-dir", type=pathlib.Path, default=None,
                    help="write each run's output there")
    ap.add_argument("--sass", default=None,
                    help="comma-separated library stems: compare their "
                    "machine code instead of timing")
    ns = ap.parse_args(argv)
    other = ns.other.resolve()
    if not (other / "chip_smoke.py").exists():
        ap.error(f"{other} holds no chip_smoke.py")
    if ns.sass:
        print(json.dumps({"other": str(other), "this": str(THIS),
                          "sass": compare_sass(other, ns.sass.split(","))}),
              flush=True)
        return 0
    if ns.log_dir is not None:
        ns.log_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (label, tree) in enumerate(
            (("other", other), ("this", THIS), ("this", THIS),
             ("other", other))):
        log = None if ns.log_dir is None else ns.log_dir / f"{i}_{label}.log"
        runs.append(run_smoke(tree, ns.phases, log))
    print(json.dumps({"card": card_name_and_limit(), "other": str(other),
                      "this": str(THIS), **in_turns(runs)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
