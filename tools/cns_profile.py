"""Profile the device cns path on full-scale artifacts, slice by slice.

Answers "where do the ~25 s/slice go at E. coli scale?" (round-3 perf
pass): loads the staged pw artifacts (reads.fasta + cand.txt), picks a
subset of templates, and runs correct_batch_device with
MECAT_CNS_TIMERS=1 so each slice logs plan / dispatch+align / vote /
pull phases separately.  Run on the real chip.

Usage: python tools/cns_profile.py [--dir .artifacts/ecoli_e2e] [--templates 200]
       [--offset 2000] [--tech 0] [--extend-batch 128]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("MECAT_CNS_TIMERS", "1")

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=".artifacts/ecoli_e2e")
    ap.add_argument("--templates", type=int, default=200)
    ap.add_argument("--offset", type=int, default=2000,
                    help="skip the shortest templates (slice plan sorts by "
                         "length; mid-range is representative)")
    ap.add_argument("--tech", type=int, default=0)
    ap.add_argument("--extend-batch", type=int, default=128)
    args = ap.parse_args(argv)

    from mecat_jax.io.packed_db import PackedDB
    from mecat_jax.pipeline.cns import (CnsOptions, CnsStats,
                                        correct_batch_device, load_supports)

    t0 = time.time()
    db = PackedDB.from_fasta(os.path.join(args.dir, "reads.fasta"))
    by_template = load_supports(os.path.join(args.dir, "cand.txt"), db, 0)
    print(f"loaded {db.n_reads} reads, {len(by_template)} templates "
          f"({time.time() - t0:.1f}s)", flush=True)

    order = sorted(by_template, key=lambda t: int(db.lengths[t]))
    templates = order[args.offset:args.offset + args.templates]
    n_sup = sum(len(by_template.get(t)) for t in templates)
    opts = CnsOptions.for_tech(args.tech, extend_batch=args.extend_batch)

    stats = CnsStats()
    t0 = time.time()
    n_out = sum(1 for _ in correct_batch_device(
        db, templates, by_template, opts, stats))
    dt = time.time() - t0
    print(json.dumps({
        "templates": len(templates), "supports_in_table": n_sup,
        "supports_aligned": stats.supports_aligned,
        "corrected": n_out, "seconds": round(dt, 1),
        "supports_per_s": round(stats.supports_aligned / dt, 1),
        "extend_batch": args.extend_batch,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
