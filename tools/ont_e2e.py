"""Config-4 measurement: yeast-scale ONT reads through the correct+trim
pipeline (BASELINE.md config 4; SURVEY.md Appendix A flow).

Simulates nanopore-profile reads from a yeast-sized genome, runs the real
`mecat_pipeline` CLI (pw -> cns -> extract -> asm overlaps -> trim) with
stage resumability, and scores the corrected reads against the truth with
the exact banded toolkit.  One JSON summary at the end.

Usage: python tools/ont_e2e.py [--dir .artifacts/ont_e2e] [--genome 12100000]
       [--cov 15] [--err 0.14] [--reads N]
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
    ap.add_argument("--dir", default=".artifacts/ont_e2e")
    ap.add_argument("--genome", type=int, default=12_100_000)
    ap.add_argument("--cov", type=float, default=15.0)
    ap.add_argument("--mean-len", type=int, default=8000)
    ap.add_argument("--err", type=float, default=0.14)
    ap.add_argument("--reads", type=int, default=0,
                    help="override read count (default: cov*genome/mean)")
    ap.add_argument("--ncand", type=int, default=50)
    ap.add_argument("--max-score", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=1,
                    help="cns correction rounds (2 = realign vs draft)")
    ap.add_argument("--draft-est-coverage", type=int, default=None,
                    help="est-coverage cap for non-final cns rounds")
    args = ap.parse_args(argv)

    d = args.dir
    os.makedirs(d, exist_ok=True)
    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.utils.sim import (PROFILE_NANOPORE, random_genome,
                                     simulate_reads)

    t_all = time.time()
    n_reads = args.reads or int(args.cov * args.genome / args.mean_len)
    genome = random_genome(args.genome, seed=201)
    db, truths = simulate_reads(genome, n_reads, mean_len=args.mean_len,
                                min_len=2000, seed=202, error_rate=args.err,
                                profile=PROFILE_NANOPORE)
    reads = os.path.join(d, "reads.fasta")
    if not os.path.exists(reads):
        offs = np.concatenate([[0], np.cumsum(db.lengths)])
        write_fasta(reads, [(db.name(i), db.codes[offs[i]:offs[i + 1]])
                            for i in range(db.n_reads)])
    summary = {"reads": int(db.n_reads), "bases": int(db.lengths.sum()),
               "err": args.err, "profile": "nanopore",
               "genome": args.genome}
    print(f"dataset: {summary}", flush=True)

    out_dir = os.path.join(d, "pipe" if args.rounds <= 1
                           else f"pipe_r{args.rounds}")
    # rounds variants share the pw leg: link candidates from the base run
    base_cand = os.path.join(d, "pipe", "candidates.txt")
    os.makedirs(out_dir, exist_ok=True)
    this_cand = os.path.join(out_dir, "candidates.txt")
    if (args.rounds > 1 and os.path.exists(base_cand)
            and not os.path.exists(this_cand)):
        # copy, not os.link: a shared inode would let any future in-place
        # rewrite of the stage output corrupt the base run's artifact
        import shutil
        shutil.copyfile(base_cand, this_cand)
    extra = ([] if args.draft_est_coverage is None else
             ["--draft-est-coverage", str(args.draft_est_coverage)])
    t0 = time.time()
    sh([sys.executable, "-m", "mecat_jax.cli.pipeline",
        "-d", reads, "-o", out_dir, "-x", "1",
        "-g", str(args.genome), "-n", str(args.ncand),
        "--rounds", str(args.rounds)] + extra)
    summary["pipeline_seconds"] = round(time.time() - t0, 1)
    for name in ("candidates.txt", "corrected.fasta", "extracted.fasta",
                 "asm_overlaps.m4", "trimmed.fasta"):
        p = os.path.join(out_dir, name)
        summary[name] = os.path.getsize(p) if os.path.exists(p) else None

    from mecat_jax.utils.accuracy import corrected_accuracy
    t0 = time.time()
    rep = corrected_accuracy(os.path.join(out_dir, "corrected.fasta"),
                             genome, truths, max_reads=args.max_score)
    ids = np.array([r.identity for r in rep.per_read])
    summary.update(
        scored_reads=len(ids), split_reads=rep.split_reads,
        missing_reads=rep.missing_reads,
        median_identity=round(float(np.median(ids)), 3),
        mean_identity=round(float(np.mean(ids)), 3),
        p10_identity=round(float(np.percentile(ids, 10)), 3),
        frac_ge_99=round(float((ids >= 99.0).mean()), 4),
        accuracy_seconds=round(time.time() - t0, 1),
        total_seconds=round(time.time() - t_all, 1),
    )
    summary["rounds"] = args.rounds
    with open(os.path.join(d, "summary.json" if args.rounds <= 1
                           else f"summary_r{args.rounds}.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
