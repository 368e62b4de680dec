"""Controlled-pile consensus harness: the fast accuracy-iteration loop.

An E. coli-scale E2E run costs ~45 min on the chip; this harness reproduces
the consensus stage in isolation in seconds on CPU: build a template +
supports by mutating a KNOWN truth sequence, run the real correction path
(pipeline.cns.correct_batch — the same vote rules as the device path,
which is differential-tested equal), and score the output against truth
with an exact banded alignment (utils/accuracy.edit_stats), decomposed
into subs/ins/dels so each vote-rule change's effect is visible per error
class.

Usage:  python tools/pile_harness.py [--piles 8] [--cov 20] [--err 0.12]
        [--len 12000] [--profile pacbio|nanopore] [--seed 1]
Sweeps: any MECAT_CNS_* env var is picked up by ops/consensus.py as
usual, so `MECAT_CNS_DEL_BIAS=0.4 python tools/pile_harness.py` is a
one-line experiment.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _kmer_codes(seq, k):
    """Rolling k-mer integer codes of a 2-bit sequence ([len-k+1])."""
    if len(seq) < k:
        return np.zeros(0, np.int64)
    w = np.lib.stride_tricks.sliding_window_view(seq.astype(np.int64), k)
    return (w * (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))).sum(axis=1)


def _seed_pair(support, template, k=13):
    """An exact shared k-mer near the support's middle — the same seed
    shape the k-mer index produces in the real pipeline.  Returns
    (spos, tpos) or None."""
    tk = _kmer_codes(template, k)
    lut = {}
    for p, c in enumerate(tk):
        lut.setdefault(int(c), p)
    sk = _kmer_codes(support, k)
    mid = len(sk) // 2
    for off in range(0, max(mid, len(sk) - mid)):
        for p in (mid - off, mid + off):
            if 0 <= p < len(sk):
                tpos = lut.get(int(sk[p]))
                if tpos is not None:
                    return p, tpos
    return None


def build_pile(rng, truth, cov, err, profile, min_frac=0.35):
    """Template + supports mutated from truth; supports cover random
    subintervals (like a real pile), mean coverage ~ cov.  Seeds are
    exact shared k-mers (what the k-mer index would produce): raw
    coordinate pairs drift by the net indel rate and would defeat the
    banded extension, just as unseeded alignment would in the pipeline."""
    from mecat_jax.utils.sim import mutate, PROFILE_PACBIO, PROFILE_NANOPORE

    prof = PROFILE_PACBIO if profile == "pacbio" else PROFILE_NANOPORE
    sub, ins, dele = (err * f for f in prof)
    L = len(truth)
    template = mutate(truth, rng, sub, ins, dele)
    reads = [template]
    seeds = []
    mean_frac = (min_frac + 1.0) / 2
    n_sup = max(1, int(round(cov / mean_frac)))
    while len(seeds) < n_sup:
        frac = rng.uniform(min_frac, 1.0)
        ln = int(frac * L)
        a = int(rng.integers(0, L - ln + 1))
        sup = mutate(truth[a:a + ln], rng, sub, ins, dele)
        sp = _seed_pair(sup, template)
        if sp is None:
            continue
        reads.append(sup)
        seeds.append(sp)
    return template, reads, seeds


def run_pile(reads, seeds, opts):
    from mecat_jax.io.packed_db import PackedDB
    from mecat_jax.io.fasta import FastaRecord
    from mecat_jax.pipeline.cns import (CnsStats, correct_batch,
                                        correct_batch_rounds)

    db = PackedDB.from_records(
        [FastaRecord(f"r{i}", r) for i, r in enumerate(reads)])
    tlen = len(reads[0])
    by_t = {0: [(i + 1, 0, sp, min(tp, tlen - 1), 100)
                for i, (sp, tp) in enumerate(seeds)]}
    out = correct_batch_rounds(db, [0], by_t, opts, CnsStats(),
                               correct=correct_batch)
    return [seg for _, seg in out]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--piles", type=int, default=8)
    ap.add_argument("--cov", type=float, default=20.0)
    ap.add_argument("--err", type=float, default=0.12)
    ap.add_argument("--len", dest="length", type=int, default=12000)
    ap.add_argument("--profile", default="pacbio",
                    choices=["pacbio", "nanopore"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--segment", type=int, default=128)
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--draft-est-coverage", type=int, default=None)
    # vote-rule overrides (default: the -x tech preset values) — sweep knobs
    ap.add_argument("--del-bias", type=float, default=None)
    ap.add_argument("--ins-bias", type=float, default=None)
    ap.add_argument("--pool-min-cov", type=int, default=None)
    ap.add_argument("--pool-min-cov-ins", type=int, default=None)
    ap.add_argument("--win-radius", type=int, default=None)
    ap.add_argument("--win-mass-frac", type=float, default=None)
    ap.add_argument("--win-peak-frac", type=float, default=None)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from mecat_jax.pipeline.cns import CnsOptions
    from mecat_jax.utils.accuracy import edit_stats, identity_pct
    from mecat_jax.utils.sim import random_genome

    from mecat_jax import constants as Cst

    tech = (Cst.TECH_PACBIO if args.profile == "pacbio"
            else Cst.TECH_NANOPORE)
    preset = Cst.CNS_TECH_PRESETS[tech]
    opts = CnsOptions(min_align_size=500, min_length=500, min_coverage=4,
                      min_mapping_ratio=0.3, align_segment=args.segment,
                      align_band=args.band, extend_batch=32,
                      min_identity=65.0, rounds=args.rounds,
                      draft_est_coverage=args.draft_est_coverage,
                      # per-tech vote rules (scale gates stay harness-sized)
                      del_bias=(args.del_bias if args.del_bias is not None
                                else preset.get("del_bias")),
                      ins_bias=(args.ins_bias if args.ins_bias is not None
                                else preset.get("ins_bias")),
                      pool_min_cov=(args.pool_min_cov
                                    if args.pool_min_cov is not None
                                    else preset.get("pool_min_cov")),
                      pool_min_cov_ins=(
                          args.pool_min_cov_ins
                          if args.pool_min_cov_ins is not None
                          else preset.get("pool_min_cov_ins")),
                      win_radius=(args.win_radius
                                  if args.win_radius is not None
                                  else preset.get("win_radius")),
                      win_mass_frac=(args.win_mass_frac
                                     if args.win_mass_frac is not None
                                     else preset.get("win_mass_frac")),
                      win_peak_frac=(args.win_peak_frac
                                     if args.win_peak_frac is not None
                                     else preset.get("win_peak_frac")))
    rng = np.random.default_rng(args.seed)
    rows = []
    for p in range(args.piles):
        truth = random_genome(args.length, seed=args.seed * 1000 + p)
        template, reads, seeds = build_pile(rng, truth, args.cov, args.err,
                                            args.profile)
        segs = run_pile(reads, seeds, opts)
        if not segs:
            rows.append({"pile": p, "identity": 0.0, "note": "no output"})
            continue
        seg = max(segs, key=len)
        st = edit_stats(seg, truth, band=512, mode=1)
        t_st = edit_stats(template, truth, band=512, mode=0)
        rows.append({
            "pile": p, "identity": round(identity_pct(st, len(seg)), 3),
            "template_identity": round(identity_pct(t_st, len(template)), 3),
            "subs": st[1], "ins": st[2], "dels": st[3], "len": len(seg),
            "n_segs": len(segs),
        })
        print(json.dumps(rows[-1]), flush=True)
    idents = [r["identity"] for r in rows]
    tot_len = sum(r.get("len", 0) for r in rows) or 1
    print(json.dumps({
        "summary": {
            "piles": args.piles, "cov": args.cov, "err": args.err,
            "profile": args.profile,
            "median_identity": round(float(np.median(idents)), 3),
            "mean_identity": round(float(np.mean(idents)), 3),
            "sub_pct": round(100 * sum(r.get("subs", 0) for r in rows)
                             / tot_len, 3),
            "ins_pct": round(100 * sum(r.get("ins", 0) for r in rows)
                             / tot_len, 3),
            "del_pct": round(100 * sum(r.get("dels", 0) for r in rows)
                             / tot_len, 3),
        }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
