"""Benchmark: overlaps/s/chip for the fused device overlap step, on the GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "overlaps/s/chip", ...}
with the device kind beside the numbers; the card's name and power limit
go to stderr.  Fails when the default device is not a GPU.

Workload: simulated PacBio-like reads (the reference's bundled E. coli data
is unavailable, see SURVEY.md provenance notice), all-vs-all overlap via
the fused scan→score→extend step on the card.
"""
from __future__ import annotations

import json
import os
import sys
import time

# --scaling / BENCH_SCALING=1: run the strong-scaling harness instead
# (mecat_jax/utils/scaling.py) on a virtual 8-device CPU mesh, which must
# be requested before the backend initialises.
_SCALING = "--scaling" in sys.argv or os.environ.get("BENCH_SCALING") == "1"
if _SCALING:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# bench shape knobs (env-overridable for quick local runs)
GENOME = int(os.environ.get("BENCH_GENOME", 500_000))
COVERAGE = float(os.environ.get("BENCH_COVERAGE", 15))
MEAN_LEN = int(os.environ.get("BENCH_MEAN_LEN", 5000))
L = int(os.environ.get("BENCH_L", 8192))
B = int(os.environ.get("BENCH_B", 128))
N_CAND = int(os.environ.get("BENCH_NCAND", 16))
CFG = dict(k=13, stride=10, max_occ=16, num_candidates=N_CAND, diag_bin=256,
           L_target=L, S=512, W=128, max_segs=30, min_align_size=1000,
           min_identity=70.0)


def build_workload():
    from mecat_jax.index.kmer_index import build_index
    from mecat_jax.utils.sim import random_genome, simulate_reads

    n_reads = int(GENOME * COVERAGE / MEAN_LEN)
    n_reads -= n_reads % B or B  # multiple of B, at least B
    n_reads = max(n_reads, B)
    log(f"bench: genome={GENOME} reads={n_reads} mean_len={MEAN_LEN}")
    genome = random_genome(GENOME, seed=91)
    db, _ = simulate_reads(genome, n_reads, mean_len=MEAN_LEN, min_len=2000,
                           seed=92, error_rate=0.12)
    t0 = time.time()
    idx = build_index(db.codes, db.starts, db.lengths, k=CFG["k"])
    log(f"bench: index build {time.time() - t0:.1f}s "
        f"({len(idx.positions)} positions)")
    return db, idx


def run_on(device, db, idx, n_batches, collect_supports=False):
    from mecat_jax.io.packed_db import upload_codes
    from mecat_jax.pipeline.device_step import overlap_step

    with jax.default_device(device):
        dev = dict(
            vol_codes=upload_codes(db.codes),
            offsets=jnp.asarray(idx.offsets),
            pos_rid=jnp.asarray(idx.pos_rid),
            pos_loc=jnp.asarray(idx.pos_loc),
            read_starts=jnp.asarray(idx.read_starts),
            read_lengths=jnp.asarray(idx.read_lengths))
        cutoff = jnp.int32(idx.max_occ_cutoff)

        def batch_args(bi):
            ids = range(bi * B, (bi + 1) * B)
            bases, lens = db.padded_batch(ids, pad_to=L)
            return (jnp.asarray(bases), jnp.asarray(lens),
                    jnp.asarray(np.arange(bi * B, (bi + 1) * B,
                                          dtype=np.int32)))

        # warmup/compile (timed separately: the compile-cache state must not
        # mix into the steady-state rate)
        t_c = time.time()
        a = batch_args(0)
        out = overlap_step(a[0], a[1], a[2], dev["vol_codes"], dev["offsets"],
                           dev["pos_rid"], dev["pos_loc"], dev["read_starts"],
                           dev["read_lengths"], cutoff, **CFG)
        jax.block_until_ready(out)
        compile_s = time.time() - t_c

        # pre-stage host batches once (host prep must not sit on the timed
        # path), then dispatch all steps async and sync at the end — the
        # production pipeline overlaps host prep with device compute the
        # same way.
        n_cycle = db.n_reads // B
        staged = [batch_args(bi % n_cycle) for bi in range(min(n_batches,
                                                               n_cycle))]
        t0 = time.time()
        outs = []
        segs = []
        for bi in range(n_batches):
            a = staged[bi % len(staged)]
            o = overlap_step(
                a[0], a[1], a[2], dev["vol_codes"],
                dev["offsets"], dev["pos_rid"], dev["pos_loc"],
                dev["read_starts"], dev["read_lengths"],
                cutoff, **CFG)
            outs.append(o.valid)
            segs.append(o.n_segs)
        # one stacked pull for both tallies
        tallies = np.asarray(jnp.stack(
            [jnp.sum(jnp.stack([jnp.sum(v) for v in outs])),
             jnp.sum(jnp.stack([jnp.sum(s) for s in segs]))]))
        overlaps, useful_segs = int(tallies[0]), int(tallies[1])
        dt = time.time() - t0

        supports = None
        if collect_supports:
            # pull full outputs of a few batches -> cns bench support table
            supports = []
            for bi in range(min(4, n_cycle)):
                a = staged[bi % len(staged)]
                o = overlap_step(
                    a[0], a[1], a[2], dev["vol_codes"], dev["offsets"],
                    dev["pos_rid"], dev["pos_loc"], dev["read_starts"],
                    dev["read_lengths"], cutoff, **CFG)
                supports.append((np.asarray(a[2]),
                                 {f: np.asarray(getattr(o, f))
                                  for f in ("target", "score", "qseed",
                                            "tseed", "valid")}))
    return overlaps, useful_segs, dt, compile_s, supports


def run_cns(db, supports):
    """Device consensus bench: supports/s/chip on real pw-produced piles.

    The support table comes from the fused overlap step's own output
    (real seeds/scores, forward strand), so the cns chunk sees the same
    pile shapes the production pipeline feeds it (BASELINE.json north star:
    'overlaps/s/chip + corrected reads/s')."""
    from mecat_jax import constants as Cst
    from mecat_jax.pipeline.cns import (CnsOptions, CnsStats,
                                        correct_batch_device, device_volume)

    max_templates = int(os.environ.get("BENCH_CNS_TEMPLATES", 128))
    by_template = {}
    for qids, o in supports:
        b, n = np.nonzero(o["valid"])
        for qid, tgt, score, qs, ts in zip(
                qids[b], o["target"][b, n], o["score"][b, n],
                o["qseed"][b, n], o["tseed"][b, n]):
            if int(qid) != int(tgt):
                by_template.setdefault(int(tgt), []).append(
                    (int(qid), 0, int(qs), int(ts), int(score)))
    templates = sorted(
        (t for t, s in by_template.items() if len(s) >= 5),
        key=lambda t: -len(by_template[t]))[:max_templates]
    if not templates:
        return None
    # pacbio preset EXCEPT min corrected length: the preset's 5000 filters
    # out nearly every mean-5kb bench read (round 3 corrected exactly 1
    # read — a useless regression signal).  2000 keeps the alignment work
    # identical while making "corrected reads" a real, ≥50-read surface.
    opts = CnsOptions.for_tech(Cst.TECH_PACBIO, min_length=2000)
    dev_vol = device_volume(db)

    def one_pass():
        stats = CnsStats()
        t0 = time.time()
        for _ in correct_batch_device(db, sorted(templates), by_template,
                                      opts, stats, dev_vol=dev_vol):
            pass
        return stats, time.time() - t0

    _, cold_dt = one_pass()            # compile ladder (or cache hits)
    stats, dt = one_pass()             # steady state
    return dict(
        cns_supports_per_s=round(stats.supports_aligned / dt, 1)
        if dt > 0 else None,
        cns_templates=stats.templates,
        cns_supports=stats.supports_aligned,
        cns_corrected_reads=stats.corrected_reads,
        cns_corrected_reads_per_s=round(stats.corrected_reads / dt, 2)
        if dt > 0 else None,
        cns_steady_s=round(dt, 2), cns_first_pass_s=round(cold_dt, 2))


def main():
    from mecat_jax.utils.device import card_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: default device is {dev.platform!r}, "
                         "not a GPU")
    log(f"bench: {dev.device_kind}; card: {card_name_and_power_limit()}")
    t_ix = time.time()
    db, idx = build_workload()
    index_build_s = time.time() - t_ix

    want_cns = os.environ.get("BENCH_CNS", "1") == "1" or "--cns" in sys.argv
    n_batches = int(os.environ.get("BENCH_BATCHES", 32))
    t0 = time.time()
    overlaps, useful_segs, dt, compile_s, supports = run_on(
        jax.devices()[0], db, idx, n_batches, collect_supports=want_cns)
    rate = overlaps / dt if dt > 0 else 0.0
    # Issued DP-cell rate: the fused step statically issues B*N candidate
    # extensions x 2 directions x max_segs segments of SxW cells per batch;
    # inactive pairs are skipped, so actual cells are lower.
    cells_issued = (n_batches * B * CFG["num_candidates"] * 2
                    * CFG["max_segs"] * CFG["S"] * CFG["W"])
    cells_per_s = cells_issued / dt if dt > 0 else 0.0
    # USEFUL cells: sum of per-lane actual DP segments (live lanes only,
    # both directions) x S x W
    cells_useful_per_s = useful_segs * CFG["S"] * CFG["W"] / dt \
        if dt > 0 else 0.0
    log(f"bench: {overlaps} overlaps in {dt:.2f}s -> {rate:.1f}/s "
        f"({cells_per_s / 1e9:.1f} Gcells/s issued, "
        f"{cells_useful_per_s / 1e9:.1f} useful, compile {compile_s:.1f}s,"
        f" total {time.time() - t0:.1f}s)")

    result = {
        "metric": "pairwise overlap throughput (fused scan+extend, simulated "
                  "PacBio reads)",
        "value": round(rate, 2),
        "unit": "overlaps/s/chip",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        # compile-cache state must not contaminate the throughput line
        "index_build_s": round(index_build_s, 1),
        "compile_s": round(compile_s, 1),
        "steady_s": round(dt, 2),
        "dp_gcells_per_s_issued": round(cells_per_s / 1e9, 2),
        "dp_gcells_per_s_useful": round(cells_useful_per_s / 1e9, 2),
        "cache": "warm" if compile_s < 15.0 else "cold",
    }
    if want_cns and supports:
        cns = run_cns(db, supports)
        if cns:
            result.update(cns)
            log(f"bench: cns: {cns['cns_supports']} supports in "
                f"{cns['cns_steady_s']}s -> {cns['cns_supports_per_s']}/s")
    print(json.dumps(result))


if __name__ == "__main__":
    if _SCALING:
        from mecat_jax.utils.scaling import main as scaling_main

        sys.exit(scaling_main())
    main()
