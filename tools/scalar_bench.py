"""Measure the scalar single-thread C++ baseline rate (BASELINE.md row).

Runs the SAME workload as bench.py (simulated PacBio reads, same k/stride/
candidate budget/DP shapes/filters) through the reference-style scalar
engine (native/src/scalar_baseline.cpp) on ONE host core, and reports
overlaps/s + candidates/s + DP cell rate.  This is the in-repo denominator
for the >=50x/socket north-star claim (VERDICT r4 next #1): a real
measured scalar C++ rate instead of the unfalsifiable XLA:CPU stand-in.

The full all-vs-all is hours of single-core wall; by default a query
SUBSET is timed against the full index (rates are per-query throughput and
stabilise within a few dozen reads).  --full times everything.

Usage: python tools/scalar_bench.py [--queries 64] [--task 1] [--full]
       [--genome 500000] [--cov 15] [--ncand 16]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # no accelerator needed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=500_000)
    ap.add_argument("--cov", type=float, default=15.0)
    ap.add_argument("--mean-len", type=int, default=5000)
    ap.add_argument("--err", type=float, default=0.12)
    ap.add_argument("--ncand", type=int, default=16)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--task", type=int, default=1)
    ap.add_argument("--S", type=int, default=512)
    ap.add_argument("--W", type=int, default=128)
    ap.add_argument("--min-align", type=int, default=1000)
    ap.add_argument("--max-occ", type=int, default=16,
                    help="matches bench.py CFG max_occ")
    ap.add_argument("--min-identity", type=float, default=70.0)
    ap.add_argument("--seed", type=int, default=91)
    ap.add_argument("--strands", type=int, default=2, choices=(1, 2),
                    help="1 = fwd-only (bench.py step parity), 2 = both")
    args = ap.parse_args(argv)

    from mecat_jax import constants as C
    from mecat_jax.native.scalar import ScalarEngine
    from mecat_jax.utils.sim import random_genome, simulate_reads

    n_reads = max(128, int(args.genome * args.cov / args.mean_len))
    print(f"scalar_bench: genome={args.genome} reads={n_reads} "
          f"mean={args.mean_len} err={args.err}", flush=True)
    genome = random_genome(args.genome, seed=args.seed)
    db, _ = simulate_reads(genome, n_reads, mean_len=args.mean_len,
                           min_len=2000, seed=args.seed + 1,
                           error_rate=args.err)

    t0 = time.time()
    eng = ScalarEngine(db.codes, db.starts, db.lengths, k=C.KMER_SIZE)
    build_s = time.time() - t0
    cutoff = eng.cutoff()
    print(f"scalar_bench: index built in {build_s:.1f}s "
          f"({eng.n_valid} positions, cutoff {cutoff})", flush=True)

    n_q = db.n_reads if args.full else min(args.queries, db.n_reads)
    t0 = time.time()
    r = eng.overlap_range(
        0, n_q, task=args.task, stride=C.KMER_SCAN_STRIDE,
        max_occ=args.max_occ, cutoff=cutoff,
        diag_bin=C.DDF_DIAG_BIN, n_cand=args.ncand,
        min_block_score=C.MIN_BLOCK_SCORE, S=args.S, W=args.W,
        penalty=C.ALIGN_TRIM_PENALTY,
        min_seg_identity=C.MIN_SEGMENT_IDENTITY,
        min_identity=args.min_identity, min_align_size=args.min_align,
        strands=args.strands)
    wall = time.time() - t0
    cells = r["dp_segments"] * args.S * args.W
    out = dict(
        queries=n_q, reads_total=db.n_reads, task=args.task,
        candidates=r["candidates"], extended=r["extended"],
        overlaps=r["overlaps"], passed=r["passed"],
        strands=args.strands,
        wall_s=round(wall, 2), scan_s=round(r["scan_s"], 2),
        extend_s=round(r["extend_s"], 2), index_build_s=round(build_s, 2),
        candidates_per_s=round(r["candidates"] / wall, 2),
        overlaps_per_s=round(r["overlaps"] / wall, 3),
        passed_per_s=round(r["passed"] / wall, 3),
        reads_per_s=round(n_q / wall, 3),
        dp_gcells_per_s=round(cells / max(r["extend_s"], 1e-9) / 1e9, 4),
        note="single thread, one host core",
    )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
