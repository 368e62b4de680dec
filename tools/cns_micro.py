"""Micro-decomposition of one cns device chunk: where does its time go?

Times, on the card with realistic full-scale shapes (P=128 pairs,
L_t=16384, L_s=32768, S=512, W=128, budget 32+32):
  a. extend_pair_batch_with_ops alone (DP + combined traceback)
  b. extend_pair_batch (counts-only twin; DP without moves/traceback)
  c. the full make_cns_chunk program (adds gathers + filters + tag fold)
Each timed warm over --reps, synchronised by pulling a result.

Usage: python tools/cns_micro.py [--pairs 128] [--lt 16384] [--segs 32]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def timeit(fn, reps):
    fn()  # warm
    t0 = time.time()
    for _ in range(reps):
        fn()
    return (time.time() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=128)
    ap.add_argument("--lt", type=int, default=16384)
    ap.add_argument("--segs", type=int, default=32)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    from mecat_jax.ops.align import (extend_pair_batch,
                                     extend_pair_batch_with_ops)
    from mecat_jax.utils.sim import mutate, random_genome

    P, L_t = args.pairs, args.lt
    L_s = 2 * L_t
    S, W, G = 512, 128, args.segs
    rng = np.random.default_rng(3)

    # realistic piles: template ~L_t, supports = mutated windows
    tmpl = random_genome(L_t - 100, seed=42)
    q = np.zeros((P, L_s), np.uint8)
    t = np.zeros((P, L_t), np.uint8)
    qlen = np.zeros(P, np.int32)
    tlen = np.full(P, len(tmpl), np.int32)
    qs = np.zeros(P, np.int32)
    ts = np.zeros(P, np.int32)
    for p in range(P):
        a = int(rng.integers(0, len(tmpl) // 2))
        b = int(rng.integers(a + 5000, len(tmpl) + 1))
        sup = mutate(tmpl[a:b], rng, 0.04, 0.04, 0.04)
        t[p, :len(tmpl)] = tmpl
        q[p, :len(sup)] = sup
        qlen[p] = len(sup)
        mid = (b - a) // 2
        qs[p] = mid
        ts[p] = a + mid
    jq, jt = jnp.asarray(q), jnp.asarray(t)
    jql, jtl = jnp.asarray(qlen), jnp.asarray(tlen)
    jqs, jts = jnp.asarray(qs), jnp.asarray(ts)

    def sync(x):
        np.asarray(x[0] if getattr(x, "ndim", 0) else x)

    def run_ops():
        pa, r, l = extend_pair_batch_with_ops(
            jq, jt, jql, jtl, jqs, jts, S=S, W=W, max_segs=G,
            max_segs_left=G)
        sync(pa.identity)
        return pa

    def run_counts():
        pa = extend_pair_batch(jq, jt, jql, jtl, jqs, jts, S=S, W=W,
                               max_segs=G)
        sync(pa.identity)
        return pa

    pa = run_ops()
    ident = np.asarray(pa.identity)
    print(f"sanity: median identity {np.median(ident):.1f}, "
          f"median span {np.median(np.asarray(pa.qend - pa.qbeg)):.0f}",
          flush=True)
    t_ops = timeit(run_ops, args.reps)
    t_cnt = timeit(run_counts, args.reps)

    # full chunk: gathers + align + filters + tag fold (both tag routes)
    from mecat_jax.pipeline.cns import make_cns_chunk
    import jax

    D1_mod = __import__("mecat_jax.constants", fromlist=["MAX_INS_DELTA"])
    D1 = D1_mod.MAX_INS_DELTA + 1
    chunk = jax.jit(make_cns_chunk(
        L_s=L_s, L_t=L_t, S=S, W=W, max_segs=G, max_segs_left=G,
        min_identity=70.0, min_align_size=500, min_mapping_ratio=0.5,
        tags="tape"),
        donate_argnums=(0, 1, 2))
    chunk_banded = jax.jit(make_cns_chunk(
        L_s=L_s, L_t=L_t, S=S, W=W, max_segs=G, max_segs_left=G,
        min_identity=70.0, min_align_size=500, min_mapping_ratio=0.5,
        tags="banded"),
        donate_argnums=(0, 1, 2))
    T = 100
    # flat volume = template then supports back to back (fwd + rc halves)
    reads = [tmpl] + [q[p, :qlen[p]] for p in range(P)]
    lens_v = np.array([len(r) for r in reads], np.int64)
    starts_v = np.concatenate([[0], np.cumsum(lens_v)[:-1]])
    n_bases = int(lens_v.sum())
    fwd = np.concatenate(reads)
    rc = np.concatenate([(3 - r)[::-1] for r in reads][::-1])
    vol_cat = jnp.asarray(np.concatenate([fwd, rc, np.zeros(L_s, np.uint8)]))
    s_ids = jnp.asarray(np.arange(1, P + 1, dtype=np.int32))
    t_ids = jnp.asarray(np.zeros(P, np.int32))
    t_slot = jnp.asarray(np.zeros(P, np.int32))
    sdir = jnp.asarray(np.zeros(P, np.int32))
    real = jnp.asarray(np.ones(P, bool))

    def run_chunk(fn):
        counts = jnp.zeros((T, L_t, D1, 5), jnp.int32)
        cov = jnp.zeros((T, L_t + 1), jnp.int32)
        has = jnp.zeros(T, bool)
        c2, v2, h2 = fn(counts, cov, has, vol_cat,
                        jnp.asarray(starts_v.astype(np.int32)),
                        jnp.asarray(lens_v.astype(np.int32)),
                        np.int32(n_bases), s_ids, t_ids, jql, jtl,
                        jqs, jts, t_slot, sdir, real)
        sync(h2)
        return c2

    t_chunk = timeit(lambda: run_chunk(chunk), args.reps)
    t_banded = timeit(lambda: run_chunk(chunk_banded), args.reps)
    ca = np.asarray(run_chunk(chunk))
    cb = np.asarray(run_chunk(chunk_banded))
    cells = 2 * G * S * W * P
    print(json.dumps({
        "pairs": P, "L_t": L_t, "segs_per_dir": G,
        "t_extend_with_ops_s": round(t_ops, 3),
        "t_extend_counts_s": round(t_cnt, 3),
        "t_full_chunk_tape_s": round(t_chunk, 3),
        "t_full_chunk_banded_s": round(t_banded, 3),
        "traceback_plus_moves_s": round(t_ops - t_cnt, 3),
        "tagfold_gather_s": round(t_chunk - t_ops, 3),
        "banded_equals_tape": bool(np.array_equal(ca, cb)),
        "issued_Gcells": round(cells / 1e9, 2),
        "counts_Gcells_per_s": round(cells / t_cnt / 1e9, 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
