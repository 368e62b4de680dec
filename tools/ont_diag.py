"""ONT config-4 tail diagnosis: accuracy vs support coverage per read.

VERDICT r3 weak #1 asked WHERE the ONT p10 tail loses identity.  The pile
study (2026-08-20) showed deletions dominate and that failing columns sit
at coverage 4-6 with votes below threshold — i.e. coverage starvation, not
vote rules.  This tool checks the corresponding e2e-level signature: reads
in the bottom identity decile should be the reads with the fewest
recruited supports.  If true, the e2e lever is recruitment (-n, mapping
ratio), not consensus.

Usage: python tools/ont_diag.py [--dir .artifacts/ont_e2e] [--rounds N]
Prints identity quartiles per support-count bin + error-class split for
the bottom decile.
"""
import argparse
import json
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=".artifacts/ont_e2e")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--genome", type=int, default=12_100_000)
    ap.add_argument("--cov", type=float, default=10.0)
    ap.add_argument("--mean-len", type=int, default=8000)
    ap.add_argument("--err", type=float, default=0.14)
    args = ap.parse_args(argv)

    from mecat_jax.utils.accuracy import corrected_accuracy
    from mecat_jax.utils.sim import (PROFILE_NANOPORE, random_genome,
                                     simulate_reads)

    pipe = os.path.join(args.dir, "pipe" if args.rounds <= 1
                        else f"pipe_r{args.rounds}")
    cand = os.path.join(pipe, "candidates.txt")
    corrected = os.path.join(pipe, "corrected.fasta")

    n_reads = int(args.cov * args.genome / args.mean_len)
    genome = random_genome(args.genome, seed=201)
    db, truths = simulate_reads(genome, n_reads, mean_len=args.mean_len,
                                min_len=2000, seed=202,
                                error_rate=args.err,
                                profile=PROFILE_NANOPORE)

    # supports per template: candidate lines contribute to BOTH sides'
    # piles (pw emits qid/sid 1-based)
    sup = Counter()
    with open(cand) as fh:
        for ln in fh:
            f = ln.split("\t", 3)
            sup[int(f[0]) - 1] += 1
            sup[int(f[1]) - 1] += 1

    rep = corrected_accuracy(corrected, genome, truths)
    ids = np.array([r.identity for r in rep.per_read])
    reads = np.array([r.read for r in rep.per_read])
    ncand = np.array([sup.get(int(r), 0) for r in reads])

    out = {"rounds": args.rounds, "n": len(ids),
           "median": round(float(np.median(ids)), 3),
           "p10": round(float(np.percentile(ids, 10)), 3)}
    bins = [0, 10, 20, 30, 45, 60, 10 ** 9]
    rows = []
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = (ncand >= lo) & (ncand < hi)
        if m.sum() == 0:
            continue
        rows.append({"supports": f"[{lo},{hi})", "reads": int(m.sum()),
                     "median": round(float(np.median(ids[m])), 3),
                     "p10": round(float(np.percentile(ids[m], 10)), 3)})
    out["by_supports"] = rows

    # error-class split, bottom decile vs rest
    thr = np.percentile(ids, 10)
    for name, m in (("bottom_decile", ids <= thr), ("rest", ids > thr)):
        tot = sum(rep.per_read[i].length + rep.per_read[i].dels
                  for i in np.nonzero(m)[0])
        out[name] = {
            "reads": int(m.sum()),
            "median_supports": float(np.median(ncand[m])),
            "sub_pct": round(100 * sum(rep.per_read[i].subs
                                       for i in np.nonzero(m)[0]) / tot, 3),
            "ins_pct": round(100 * sum(rep.per_read[i].ins
                                       for i in np.nonzero(m)[0]) / tot, 3),
            "del_pct": round(100 * sum(rep.per_read[i].dels
                                       for i in np.nonzero(m)[0]) / tot, 3),
        }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
