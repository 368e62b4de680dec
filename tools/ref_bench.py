"""mecat2ref throughput at genome scale (VERDICT round-2 item 5).

Simulates a chr21-sized reference (default 46 Mb) plus PacBio-profile reads,
runs the real mecat2ref CLI (two-phase counts-then-ops path) in SAM and M4
modes, and prints one JSON line with reads/s plus a coordinate sanity check
(mapped intervals must cover the true sampled locus for >= 95% of reads).

Usage: python tools/ref_bench.py [--ref-mb 46] [--reads 2000] [--dir d]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=".artifacts/ref_bench")
    ap.add_argument("--ref-mb", type=float, default=46.0)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--mean-len", type=int, default=10000)
    ap.add_argument("--err", type=float, default=0.12)
    args = ap.parse_args(argv)

    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.utils.sim import random_genome, simulate_reads

    d = args.dir
    os.makedirs(d, exist_ok=True)
    G = int(args.ref_mb * 1e6)
    ref_path = os.path.join(d, "ref.fasta")
    reads_path = os.path.join(d, "reads.fasta")
    genome = random_genome(G, seed=301)
    if not os.path.exists(ref_path):
        write_fasta(ref_path, [("chr_sim", genome)])
    db, truths = simulate_reads(genome, args.reads, mean_len=args.mean_len,
                                min_len=3000, seed=302,
                                error_rate=args.err)
    if not os.path.exists(reads_path):
        offs = np.concatenate([[0], np.cumsum(db.lengths)])
        write_fasta(reads_path, [(db.name(i), db.codes[offs[i]:offs[i + 1]])
                                 for i in range(db.n_reads)])

    out = {"ref_bases": G, "reads": int(db.n_reads),
           "read_bases": int(db.lengths.sum())}
    # the CLI child holds the card; this parent stays off the device
    env = dict(os.environ)
    for mode, flag, name in (("sam", [], "out.sam"),):
        t0 = time.time()
        subprocess.run(
            [sys.executable, "-m", "mecat_jax.cli.mecat2ref", "-d",
             reads_path, "-r", ref_path, "-w", os.path.join(d, "wrk"),
             "-o", os.path.join(d, name)] + flag, check=True, env=env)
        dt = time.time() - t0
        out[f"{mode}_seconds"] = round(dt, 1)
        out[f"{mode}_reads_per_s"] = round(db.n_reads / dt, 1)

    # truth sanity: primary mapping interval must overlap the sampled locus
    ok = 0
    mapped = 0
    names = {}
    with open(os.path.join(d, "out.sam")) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.split("\t")
            flagv = int(f[1])
            if flagv & 0x900:        # secondary/supplementary
                continue
            if flagv & 0x4:
                continue
            mapped += 1
            names[f[0]] = int(f[3]) - 1
    for i, tr in enumerate(truths):
        pos = names.get(db.name(i))
        if pos is None:
            continue
        lo, hi = tr.start, tr.end
        if lo - 2000 <= pos <= hi + 2000:
            ok += 1
    out["mapped"] = mapped
    out["pos_agree"] = round(ok / max(mapped, 1), 4)
    print(json.dumps(out), flush=True)
    assert out["pos_agree"] >= 0.95, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
