"""How much shared memory does a thread block really get on this card?

    python -m optflow_tpu_torch.tools.smem_cap [--device cuda]

Counterpart of the JAX package's ``tools/probes/r4_vmem_cap.py``: a kernel
fills N bytes of on-chip scratch, sums it and returns the mean
(``ops/smem_cap_cuda.py``), and the tool reports the largest N that is
granted AND runs. Per size (16 ... 228 KiB) it prints

  OK / FAIL   of one block, with the CUDA status that refused it;
  occupancy   blocks of 1024 threads the runtime says fit one multiprocessor
              (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
  resident    a second, cooperative launch of multiprocessors x occupancy
              blocks, every one of which must return the mean: the runtime
              refuses a cooperative grid that cannot be resident at once, so
              a pass shows the occupancy really holds (and one block more
              must be refused).

It also prints the card's own limits (the opt-in limit of a block and the
shared memory of a multiprocessor) and checks the constants the port's
kernels rest on against the largest size that ran: the blocked level
kernel's window and the chunk kernel's one-block limit.
"""

from __future__ import annotations

import argparse
from typing import List

import torch

from optflow_tpu_torch.ops import smem_cap_cuda as probe
from optflow_tpu_torch.ops.tvl1_chunk_cuda import ONE_BLOCK_MAX_PX

SIZES_KIB = (16, 32, 48, 64, 96, 128, 160, 192, 224, 227, 228)
FILL = 3.0
THREADS = 1024

# Dynamic shared memory the port's kernels ask for: the blocked level
# kernel's 64 x 96 window of 9 float planes (csrc/tvl1_blocked.cu), and the
# chunk kernel's largest one-block level at 36 B a pixel.
BLOCKED_WINDOW_BYTES = 9 * 64 * 96 * 4
CHUNK_ONE_BLOCK_BYTES = ONE_BLOCK_MAX_PX * 36


def run_probe(device="cuda", sizes_kib=SIZES_KIB) -> dict:
    """The table as a dict: ``attrs``, one row per size under ``sizes``,
    ``largest_ok_bytes`` and the two constants' checks."""
    dev = torch.device(device)
    x = torch.full((1,), FILL, dtype=torch.float32, device=dev)
    on_card = dev.type == "cuda"
    attrs = probe.device_shared_memory(dev)._asdict() if on_card else None
    rows: List[dict] = []
    largest = 0
    for kib in sizes_kib:
        n_bytes = kib * 1024
        status, means = probe.smem_fill_mean(n_bytes, x)
        ok = status.ok and abs(float(means[0]) - FILL) <= 1e-6
        row = {"kib": kib, "bytes": n_bytes, "ok": ok,
               "status": list(status)}
        if not status.ok:
            row["refused_by"] = probe.error_string(
                status.attribute or status.launch)
        if ok:
            largest = max(largest, n_bytes)
        if ok and on_card:
            occ = probe.occupancy(n_bytes, THREADS, dev)
            blocks = attrs["multiprocessors"] * occ
            st2, means2 = probe.smem_fill_mean(
                n_bytes, x, blocks, threads=THREADS, cooperative=True)
            st3, _ = probe.smem_fill_mean(
                n_bytes, x, blocks + 1, threads=THREADS, cooperative=True)
            row.update({
                "occupancy": occ, "blocks": blocks,
                "resident": bool(
                    st2.ok and float((means2 - FILL).abs().max()) <= 1e-6),
                "one_more_refused": not st3.ok,
            })
        rows.append(row)
    return {
        "device": str(dev), "attrs": attrs, "sizes": rows,
        "largest_ok_bytes": largest,
        "blocked_window_bytes": BLOCKED_WINDOW_BYTES,
        "blocked_window_fits": BLOCKED_WINDOW_BYTES <= largest,
        "chunk_one_block_bytes": CHUNK_ONE_BLOCK_BYTES,
        "chunk_one_block_fits": CHUNK_ONE_BLOCK_BYTES <= largest,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Probe the dynamic shared memory a thread block gets.")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    table = run_probe(ns.device)
    if table["attrs"] is not None:
        from optflow_tpu_torch.tools.kernel_ablate import card_name_and_limit

        a = table["attrs"]
        print("card:", card_name_and_limit())
        print(f"cudaDevAttrMaxSharedMemoryPerBlockOptin: {a['optin_per_block']} B")
        print("cudaDevAttrMaxSharedMemoryPerMultiprocessor: "
              f"{a['per_multiprocessor']} B")
        print(f"multiprocessors: {a['multiprocessors']}")
    else:
        print("device: cpu (plain version; nothing can be refused)")
    for r in table["sizes"]:
        line = f"shared {r['kib']:4d} KiB: {'OK' if r['ok'] else 'FAIL'}"
        if "occupancy" in r:
            line += (f"  occupancy {r['occupancy']} x {THREADS} threads, "
                     f"{r['blocks']} blocks resident: "
                     f"{'OK' if r['resident'] else 'FAIL'}, one more "
                     f"{'refused' if r['one_more_refused'] else 'NOT refused'}")
        if "refused_by" in r:
            line += f"  ({r['refused_by']})"
        print(line)
    print(f"largest size that ran: {table['largest_ok_bytes']} B")
    for what, key in (("blocked level kernel's window", "blocked_window"),
                      ("chunk kernel's one-block limit", "chunk_one_block")):
        print(f"{what}: {table[key + '_bytes']} B "
              f"{'fits' if table[key + '_fits'] else 'DOES NOT FIT'}")
    ok = table["blocked_window_fits"] and table["chunk_one_block_fits"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
