"""The port's multi-host launcher, two real processes on the CPU: the
counterpart of tests/test_multihost.py. Drives
``python -m optflow_tpu_torch.cli.run_pod`` end to end — the gloo rendezvous
of torch.distributed, each process's share of the image list, its local
mesh, the batched solve, the per-process journals and the final barrier."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_pod_run(tmp_path, rng):
    from PIL import Image

    from tests.conftest import make_fibsem_like

    n_pairs = 4
    ims = [make_fibsem_like(rng, 32, 48) for _ in range(n_pairs + 1)]
    for i, im in enumerate(ims):
        Image.fromarray(im.astype(np.uint8)).save(str(tmp_path / f"f{i}.png"))
    job = {
        "style": 1, "scale": 1.0, "output_type": "flow",
        "output_dir": str(tmp_path / "out"), "rois": {"top": 16},
        "journal": str(tmp_path / "journal.jsonl"), "pair_batch": 2,
        "prefetch": False, "nscales": 2, "warps": 1, "iterations": 10,
        "images": [{"p": str(tmp_path / f"f{i}.png"),
                    "q": str(tmp_path / f"f{i + 1}.png"),
                    "output_name": f"n{i}"} for i in range(n_pairs)],
    }
    job_path = tmp_path / "job.json"
    job_path.write_text(json.dumps(job))

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "optflow_tpu_torch.cli.run_pod",
             str(job_path), "--device", "cpu",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(pid)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for pid, proc in enumerate(procs):
            out, err = proc.communicate(timeout=120)
            outs.append(out)
            assert proc.returncode == 0, f"host {pid} failed:\n{out}\n{err}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()

    assert "[host 0/2] done:" in outs[0]
    assert "[host 1/2] done:" in outs[1]
    # every pair solved exactly once across the two hosts
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == sorted(f"n{i}_1.00_top_{c}.tiff"
                             for i in range(n_pairs) for c in "xy")
    # per-process journals recorded disjoint halves: host r the pairs r::2
    for pid in range(2):
        lines = (tmp_path / f"journal.jsonl.{pid}").read_text().splitlines()
        recs = [json.loads(ln) for ln in lines if '"pair"' in ln]
        # a key is "p|q|output_name|params"
        names = sorted(r["key"].split("|")[2] for r in recs)
        assert names == [f"n{i}" for i in range(pid, n_pairs, 2)]
