"""Diagnose the residual-deletion floor on nanopore piles.

Builds one pile with a TRACKED template mutation (we know every truth base
the template dropped and its template anchor), runs the real host consensus
path capturing the CnsTable, and classifies every template-deletion site:
  - restored: an insertion slot at/near the anchor emitted the missing base
  - votes_lost: insertion votes at the anchor below the plurality threshold
  - anchored_elsewhere: votes exist but spread over neighbouring anchors
This tells us WHICH mechanism the 0.8%-dels floor comes from before
touching any vote rule.  Usage: python tools/diag_dels.py [--cov 24]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def mutate_tracked(truth, rng, sub, ins, dele):
    """Like utils.sim.mutate but records deletions: returns (seq, dels)
    where dels = list of (template_anchor_pos, truth_base) — anchor is the
    index IN THE OUTPUT of the last emitted base before the dropped one."""
    out = []
    dels = []
    lut = np.arange(4, dtype=np.uint8)
    for i, b in enumerate(truth):
        r = rng.random()
        if r < dele:
            dels.append((len(out) - 1, int(b)))
            continue
        if r < dele + sub:
            out.append(int((b + 1 + rng.integers(0, 3)) % 4))
        else:
            out.append(int(b))
        if rng.random() < ins:
            out.append(int(lut[rng.integers(0, 4)]))
    return np.asarray(out, dtype=np.uint8), dels


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cov", type=float, default=24.0)
    ap.add_argument("--err", type=float, default=0.13)
    ap.add_argument("--len", dest="length", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")

    from tools.pile_harness import _seed_pair
    from mecat_jax.utils.sim import random_genome, mutate, PROFILE_NANOPORE
    from mecat_jax.io.packed_db import PackedDB
    from mecat_jax.io.fasta import FastaRecord
    from mecat_jax.pipeline.cns import CnsOptions, CnsStats, correct_batch
    from mecat_jax import constants as Cst
    from mecat_jax.ops import consensus as cons

    rng = np.random.default_rng(args.seed)
    truth = random_genome(args.length, seed=1234)
    sub, ins, dele = (args.err * f for f in PROFILE_NANOPORE)
    template, dels = mutate_tracked(truth, rng, sub, ins, dele)
    print(f"template: {len(template)} bases, {len(dels)} tracked deletions")

    reads = [template]
    seeds = []
    L = len(truth)
    mean_frac = (0.35 + 1.0) / 2
    n_sup = max(1, int(round(args.cov / mean_frac)))
    while len(seeds) < n_sup:
        frac = rng.uniform(0.35, 1.0)
        ln = int(frac * L)
        a = int(rng.integers(0, L - ln + 1))
        sup = mutate(truth[a:a + ln], rng, sub, ins, dele)
        sp = _seed_pair(sup, template)
        if sp is None:
            continue
        reads.append(sup)
        seeds.append(sp)

    preset = Cst.CNS_TECH_PRESETS[Cst.TECH_NANOPORE]
    opts = CnsOptions(min_align_size=500, min_length=500, min_coverage=4,
                      min_mapping_ratio=0.3, align_segment=128,
                      align_band=64, extend_batch=32, min_identity=65.0,
                      del_bias=preset.get("del_bias"),
                      ins_bias=preset.get("ins_bias"),
                      pool_min_cov_ins=preset.get("pool_min_cov_ins"))

    captured = {}
    orig = cons.CnsTable.call

    def spy(self, *a, **kw):
        captured["table"] = self
        return orig(self, *a, **kw)

    cons.CnsTable.call = spy
    db = PackedDB.from_records(
        [FastaRecord(f"r{i}", r) for i, r in enumerate(reads)])
    tlen = len(template)
    by_t = {0: [(i + 1, 0, sp, min(tp, tlen - 1), 100)
                for i, (sp, tp) in enumerate(seeds)]}
    correct_batch(db, [0], by_t, opts, CnsStats())
    cons.CnsTable.call = orig
    tb = captured["table"]

    counts, coverage = tb.counts, tb.coverage
    # emit decision replica (per-slot plurality, prefix rule)
    ins_tot = counts[:, 1:, :4].sum(axis=2)
    ins_win = np.argmax(counts[:, 1:, :4], axis=2)
    ins_emit = np.cumprod(
        ins_tot * 2 > np.maximum(coverage, 1)[:, None], axis=1).astype(bool)

    n_restored = n_votes_lost = n_spread = n_lowcov = n_edge = 0
    hp = 0
    detail = []
    for anchor, b in dels:
        if anchor < 0 or anchor >= tlen - 1:
            n_edge += 1
            continue
        cov = int(coverage[anchor])
        if cov < opts.min_coverage:
            n_lowcov += 1
            continue
        # homopolymer context: deleted base equals template anchor letter or
        # the next letter (run-pooled rule territory)
        is_hp = (int(template[anchor]) == b or
                 (anchor + 1 < tlen and int(template[anchor + 1]) == b))
        hp += is_hp
        emitted = any(ins_emit[anchor, d] and int(ins_win[anchor, d]) == b
                      for d in range(ins_emit.shape[1]))
        v_here = int(counts[anchor, 1:, b].sum())
        v_near = int(counts[max(0, anchor - 1):anchor + 2, 1:, b].sum())
        if emitted or is_hp:
            n_restored += 1  # hp: pooled rule decides; count separately
            continue
        if v_near > cov and v_here * 2 <= cov:
            n_spread += 1
        else:
            n_votes_lost += 1
        # shifted-repeat artifact signature: a plurality GAP win within +-6
        # of the anchor, with comparable total insertion mass nearby that
        # failed to concentrate (the "concentrated deletion + scattered
        # insertion" equal-cost failure mode)
        lo, hi2 = max(0, anchor - 6), min(tlen, anchor + 7)
        gap_win = (counts[lo:hi2, 0, 4] >
                   counts[lo:hi2, 0, :4].max(axis=1)).sum()
        ins_mass = int(counts[lo:hi2, 1:, :4].sum())
        if ins_mass * 2 > cov:
            main._winmass = getattr(main, "_winmass", 0) + 1
        if gap_win:
            n_gapwin = getattr(main, "_gapwin", 0) + 1
            main._gapwin = n_gapwin
            if ins_mass >= cov // 2:
                main._gapwin_comp = getattr(main, "_gapwin_comp", 0) + 1
        if len(detail) < 12:
            # how many supports contributed ANY delta-0 tag at this position
            # (match/sub/GAP) — low vs cov means alignments skipped the spot
            voted0 = int(counts[anchor, 0, :].sum())
            nb_ins = {int(bb): int(counts[anchor, 1:, bb].sum())
                      for bb in range(4)}
            detail.append(dict(anchor=int(anchor), base=b, cov=cov,
                               v_here=v_here, v_near=v_near,
                               thresh=cov // 2 + 1, voted0=voted0,
                               ins_by_base=nb_ins))
    print(f"tracked dels: {len(dels)}; emitted-or-hp-pooled {n_restored}, "
          f"votes_lost {n_votes_lost}, spread_anchors {n_spread}, "
          f"low_cov {n_lowcov}, edge {n_edge} (hp-context {hp}); "
          f"failing anchors with nearby GAP-plurality win "
          f"{getattr(main, '_gapwin', 0)} "
          f"(comp ins {getattr(main, '_gapwin_comp', 0)}); win-mass-recoverable {getattr(main, '_winmass', 0)}")
    alpha = np.array(list("ACGT"))
    for d in detail:
        a = d["anchor"]
        ctx = "".join(alpha[template[max(0, a - 6):a + 7]])
        print(d, "tmpl[-6:+7]=", ctx[:7] + "|" + ctx[7:],
              "missing=", alpha[d["base"]])


if __name__ == "__main__":
    main()
