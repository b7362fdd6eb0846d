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
shared memory of a multiprocessor) and checks the shared memory the port's
kernels ask for against the largest size that ran: the window of the
blocked kernel's replaced per-chunk entry, the chunk kernel's one-block
limit, the level grid's window (from the tile and halo its library reports)
and the ablation kernel's block (as its library reports it). On the CPU the
grid's window comes from the level wrapper's mirror of its tile and halo, and
the ablation kernel's block is not known (no library is built there).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from optflow_tpu_torch.ops import smem_cap_cuda as probe
from optflow_tpu_torch.ops import tvl1_ablate_cuda, tvl1_cuda
from optflow_tpu_torch.ops.tvl1_chunk_cuda import ONE_BLOCK_MAX_PX

SIZES_KIB = (16, 32, 48, 64, 96, 128, 160, 192, 224, 227, 228)
FILL = 3.0
THREADS = 1024

# Dynamic shared memory the port's kernels ask for: the blocked level
# kernel's 64 x 96 window of 9 float planes (csrc/tvl1_blocked.cu), and the
# chunk kernel's largest one-block level at 36 B a pixel.
BLOCKED_WINDOW_BYTES = 9 * 64 * 96 * 4
CHUNK_ONE_BLOCK_BYTES = ONE_BLOCK_MAX_PX * 36


def grid_window_bytes(on_card: bool) -> int:
    """Dynamic shared memory of the level grid's largest window: 9 float
    planes of a tile and its halo on every side, from the tile and halo that
    csrc/tvl1_grid.cuh reports through the level kernel's library (the
    wrapper's mirror of them on the CPU)."""
    if on_card:
        lib = tvl1_cuda._library()
        tile_h, tile_w = lib.tvl1_level_tile_h(), lib.tvl1_level_tile_w()
        halo = lib.tvl1_level_halo()
    else:
        tile_h, tile_w = tvl1_cuda.LEVEL_TILE_H, tvl1_cuda.LEVEL_TILE_W
        halo = tvl1_cuda.LEVEL_HALO
    return 9 * (tile_h + 2 * halo) * (tile_w + 2 * halo) * 4


def ablate_block_bytes(on_card: bool) -> Optional[int]:
    """Shared memory a block of the ablation kernel holds, as its library
    reports it; None on the CPU, where no library is built."""
    if on_card:
        return tvl1_ablate_cuda._library().tvl1_ablate_smem_bytes()
    return None


# table key -> what the tool prints for it
CONSTANTS = {
    "blocked_window": "replaced per-chunk entry's window (blocked kernel)",
    "chunk_one_block": "chunk kernel's one-block limit",
    "grid_window": "level grid's window",
    "ablate_block": "ablation kernel's block",
}


def run_probe(device="cuda", sizes_kib=SIZES_KIB) -> dict:
    """The table as a dict: ``attrs``, one row per size under ``sizes``,
    ``largest_ok_bytes``, and for each key of :data:`CONSTANTS` its bytes
    (``<key>_bytes``) and whether they fit (``<key>_fits``; both None where
    the size is not known)."""
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
    table = {"device": str(dev), "attrs": attrs, "sizes": rows,
             "largest_ok_bytes": largest}
    for key, n_bytes in (("blocked_window", BLOCKED_WINDOW_BYTES),
                         ("chunk_one_block", CHUNK_ONE_BLOCK_BYTES),
                         ("grid_window", grid_window_bytes(on_card)),
                         ("ablate_block", ablate_block_bytes(on_card))):
        table[key + "_bytes"] = n_bytes
        table[key + "_fits"] = None if n_bytes is None else n_bytes <= largest
    return table


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
    for key, what in CONSTANTS.items():
        if table[key + "_bytes"] is None:
            print(f"{what}: known from its library on a card")
            continue
        print(f"{what}: {table[key + '_bytes']} B "
              f"{'fits' if table[key + '_fits'] else 'DOES NOT FIT'}")
    return 1 if any(table[key + "_fits"] is False for key in CONSTANTS) else 0


if __name__ == "__main__":
    raise SystemExit(main())
