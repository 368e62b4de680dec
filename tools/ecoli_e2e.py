"""E. coli-scale end-to-end measurement: pw -> cns -> truth accuracy.

One-shot driver for the round's headline numbers (BASELINE.md rows):
regenerates the canonical simulated dataset (seeds 101/102 — the same set
every prior measurement used), runs the real CLIs stage by stage with
durable artifacts (reruns skip finished stages), scores corrected reads
against the truth genome with the exact banded toolkit
(utils/accuracy.corrected_accuracy), and writes one JSON summary.

Usage:  python tools/ecoli_e2e.py [--dir .artifacts/ecoli_e2e] [--reads 9216]
        [--genome 4600000] [--skip-pw] [--tech 0|1] [--err 0.12]
Stages are resumable: an existing cand.txt / corrected.fasta is reused.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def sh(cmd):
    """Run one CLI stage in a child process.  This parent never touches the
    device (one JAX process per card): it only simulates and scores."""
    print("+", " ".join(cmd), flush=True)
    t0 = time.time()
    subprocess.run(cmd, check=True)
    return time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=".artifacts/ecoli_e2e")
    ap.add_argument("--reads", type=int, default=9216)
    ap.add_argument("--genome", type=int, default=4_600_000)
    ap.add_argument("--err", type=float, default=0.12)
    ap.add_argument("--tech", type=int, default=0)
    ap.add_argument("--ncand", type=int, default=100)
    ap.add_argument("--max-score", type=int, default=None,
                    help="cap scored reads for a faster accuracy pass")
    ap.add_argument("--rounds", type=int, default=1,
                    help="cns correction rounds (2 = realign vs draft)")
    ap.add_argument("--draft-est-coverage", type=int, default=None,
                    help="est-coverage cap for non-final rounds")
    args = ap.parse_args(argv)

    d = args.dir
    os.makedirs(d, exist_ok=True)
    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.utils.sim import random_genome, simulate_reads

    t_all = time.time()
    genome = random_genome(args.genome, seed=101)
    db, truths = simulate_reads(genome, args.reads, mean_len=10000,
                                min_len=3000, seed=102, error_rate=args.err)
    reads = os.path.join(d, "reads.fasta")
    if not os.path.exists(reads):
        offs = np.concatenate([[0], np.cumsum(db.lengths)])
        write_fasta(reads, [(db.name(i), db.codes[offs[i]:offs[i + 1]])
                            for i in range(db.n_reads)])
    print(f"dataset: {db.n_reads} reads, {int(db.lengths.sum())} bases",
          flush=True)

    summary = {"reads": int(db.n_reads), "bases": int(db.lengths.sum()),
               "err": args.err, "tech": args.tech}
    py = [sys.executable, "-m"]

    cand = os.path.join(d, "cand.txt")
    if not os.path.exists(cand):
        summary["pw_seconds"] = round(sh(
            py + ["mecat_jax.cli.mecat2pw", "-j", "0", "-d", reads,
                  "-o", cand, "-w", os.path.join(d, "wrk_pw"),
                  "-n", str(args.ncand)]), 1)
    n_cand = sum(1 for _ in open(cand, "rb"))
    summary["candidates"] = n_cand
    print(f"candidates: {n_cand}", flush=True)

    corrected = os.path.join(d, "corrected.fasta"
                             if args.rounds <= 1 else
                             f"corrected.r{args.rounds}.fasta")
    if not os.path.exists(corrected):
        extra = ([] if args.draft_est_coverage is None else
                 ["--draft-est-coverage", str(args.draft_est_coverage)])
        summary["cns_seconds"] = round(sh(
            py + ["mecat_jax.cli.mecat2cns", "-i", "0", "-x", str(args.tech),
                  "--rounds", str(args.rounds)] + extra
            + [cand, reads, corrected]), 1)
    summary["rounds"] = args.rounds

    from mecat_jax.utils.accuracy import corrected_accuracy
    t0 = time.time()
    rep = corrected_accuracy(corrected, genome, truths,
                             max_reads=args.max_score)
    ids = np.array([r.identity for r in rep.per_read])
    lens = np.array([r.length for r in rep.per_read])
    summary.update(
        scored_reads=len(ids), split_reads=rep.split_reads,
        missing_reads=rep.missing_reads,
        median_identity=round(float(np.median(ids)), 3),
        mean_identity=round(float(np.mean(ids)), 3),
        p10_identity=round(float(np.percentile(ids, 10)), 3),
        frac_ge_99=round(float((ids >= 99.0).mean()), 4),
        corrected_bases=int(lens.sum()),
        accuracy_seconds=round(time.time() - t0, 1),
        total_seconds=round(time.time() - t_all, 1),
    )
    out = os.path.join(d, "summary.json")
    with open(out, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
