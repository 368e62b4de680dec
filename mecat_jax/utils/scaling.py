"""Scaling-efficiency measurement harness.

BASELINE.md's north-star includes ">= 80% scaling efficiency, 1 host -> 4
hosts" (SURVEY.md §2.3 grid scale-out restatement).  This harness gives
the target a TRACKED number on whatever devices exist: it runs the production sharded overlap step
(parallel/sharded.py — the same kernel run_pw_dist drives) at increasing
mesh widths over whatever devices exist (a virtual CPU mesh here, a real
slice in production) and reports per-config steady-state step time,
strong-scaling efficiency, and the hash-axis collective overhead.

Caveat recorded in every row: on a virtual CPU mesh all "devices" share the
host's cores, so absolute efficiency numbers are meaningless there — the
harness exists so the measurement is wired, regression-visible, and ready
to produce real numbers on real hardware (`python bench.py --scaling`).
"""
from __future__ import annotations

import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np


def _median_step_time(step, args, n_batches: int) -> float:
    import jax

    out = step(*args)                      # compile + warm
    jax.block_until_ready(out)
    times = []
    for _ in range(n_batches):
        t0 = time.time()
        jax.block_until_ready(step(*args))
        times.append(time.time() - t0)
    return float(np.median(times))


def scaling_report(mesh_shapes: Optional[List[Tuple[int, int]]] = None,
                   batch: int = 64, n_batches: int = 4,
                   n_reads: int = 64, genome_n: int = 60_000,
                   emit=print) -> List[dict]:
    """Measure the sharded overlap step across mesh widths.

    Returns one dict per (n_data, n_hash) config: median step seconds,
    throughput relative to the 1-device config, and strong-scaling
    efficiency t(1) / (n_dev * t(n_dev)).  The global batch is FIXED
    (strong scaling — the config-5 shape: same dataset, more hosts).
    """
    import jax

    from ..index.kmer_index import build_index
    from ..parallel.sharded import (make_mesh, place_sharded_inputs,
                                    shard_index_by_hash,
                                    sharded_overlap_step)
    from ..utils.sim import random_genome, simulate_reads

    devs = jax.devices()
    if mesh_shapes is None:
        mesh_shapes = [(d, h) for d, h in
                       ((1, 1), (2, 1), (4, 1), (2, 2), (4, 2), (8, 1))
                       if d * h <= len(devs)]
    cfg = dict(k=13, stride=8, max_occ=16, num_candidates=8, diag_bin=256,
               L_target=4096, S=256, W=128, max_segs=12, min_align_size=500,
               min_identity=65.0)

    genome = random_genome(genome_n, seed=111)
    db, _ = simulate_reads(genome, n_reads, mean_len=3000, min_len=1500,
                           seed=112, error_rate=0.1)
    idx = build_index(db.codes, db.starts, db.lengths, k=cfg["k"])
    ids = np.arange(batch) % db.n_reads
    bases, lens = db.padded_batch(ids, pad_to=4096)
    self_id = ids.astype(np.int32)

    rows = []
    t1 = None
    for n_data, n_hash in mesh_shapes:
        n_dev = n_data * n_hash
        if batch % n_dev:
            continue
        mesh = make_mesh(n_data=n_data, n_hash=n_hash,
                         devices=devs[:n_dev])
        off_sh, rid_sh, loc_sh, lo = shard_index_by_hash(idx, n_hash)
        step = sharded_overlap_step(mesh, **cfg)
        args = place_sharded_inputs(
            mesh, bases, lens, self_id, db.codes, off_sh, rid_sh, loc_sh,
            lo, idx.read_starts, idx.read_lengths,
            np.int32(idx.max_occ_cutoff))
        t = _median_step_time(step, args, n_batches)
        if t1 is None:
            t1 = t * n_dev  # normalise to a 1-device-equivalent reference
        row = {
            "n_data": n_data, "n_hash": n_hash, "n_devices": n_dev,
            "step_seconds": round(t, 4),
            "speedup_vs_1dev": round(t1 / t, 3) if t > 0 else None,
            "scaling_efficiency": round(t1 / (n_dev * t), 3)
            if t > 0 else None,
            "platform": devs[0].platform,
            "virtual_mesh": devs[0].platform == "cpu",
        }
        rows.append(row)
        if emit:
            emit(json.dumps({"scaling": row}))

    # hash-axis collective overhead: same device count, hash=2 vs hash=1
    by = {(r["n_data"], r["n_hash"]): r for r in rows}
    for d, h in list(by):
        if h == 2 and (2 * d, 1) in by:
            base = by[(2 * d, 1)]["step_seconds"]
            ovh = by[(d, 2)]["step_seconds"] / base - 1 if base > 0 else None
            row = {"n_devices": 2 * d,
                   "hash_collective_overhead": round(ovh, 3)
                   if ovh is not None else None}
            rows.append(row)
            if emit:
                emit(json.dumps({"scaling": row}))
    return rows


def main(argv=None) -> int:
    rows = scaling_report()
    eff_rows = [r for r in rows if r.get("scaling_efficiency") is not None]
    best_at_max = None
    if eff_rows:
        n_max = max(r["n_devices"] for r in eff_rows)
        best_at_max = max(r["scaling_efficiency"] for r in eff_rows
                          if r["n_devices"] == n_max)
    print(json.dumps({
        "metric": "sharded overlap step strong-scaling report",
        "value": best_at_max,
        "unit": "efficiency@max_devices",
        "rows": rows,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
