"""Isolated A/B of the banded DP segment: plain XLA scan vs the CUDA kernel.

One DP segment (``ops.align.dp_segment_best``) over B pairs at forced full
occupancy (every pair active, a full S-row segment of a 12%-error pair),
in both variants: with moves (the cns/ref traceback path) and counts-only
(the pw path).  For each (W, variant) it checks the kernel against the
plain path for exact equality on every output, then times both and
prints DP cells/s (B * S * W / time).  Run on the card:

    python tools/roofline.py [--b 2048] [--s 512] [--w 128,64] [--reps 20]

With ``--e2e`` it instead runs the smoke's pw ``-j 1`` and cns phases end
to end (chip_smoke.py's data: 1 Mb genome, 2,000 reads) in one process, on
each DP path in turn (plain, kernel, plain; the path is chosen with
``ops.align.dp_path``; run after chip_smoke.py with the same compile
cache, so the kernel pass and the second plain pass are warm), checks that
both paths write the same records, and prints every stage wall.

Prints the card's name and power limit, each compiled step's memory
analysis, and one JSON line (also written to chiprun_out/roofline.json).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def make_pairs(B, S, W, err=0.12, seed=11):
    """Random segment pairs: query [B, S], target window [B, S + W//2]."""
    from mecat_jax.ops.align import Q_SENTINEL, T_SENTINEL
    from mecat_jax.utils.sim import PROFILE_PACBIO, mutate

    rng = np.random.default_rng(seed)
    q = np.full((B, S), Q_SENTINEL, np.uint8)
    t = np.full((B, S + W // 2), T_SENTINEL, np.uint8)
    tmax = np.zeros(B, np.int32)
    seg_q = np.zeros(B, np.int32)
    sub, ins, dele = (err * f for f in PROFILE_PACBIO)
    for b in range(B):
        src = rng.integers(0, 4, S + W, dtype=np.uint8)
        dst = mutate(src, rng, sub, ins, dele)[:S + W // 2]
        q[b] = src[:S]
        t[b, :len(dst)] = dst
        tmax[b] = len(dst)
        seg_q[b] = S
    return q, t, tmax, seg_q


def dp_fns(S, W, with_moves):
    import jax

    from mecat_jax.ops.align import dp_segment_best

    def make(kernel):
        def f(q, t, tmax, seg_q):
            out = dp_segment_best(q, t, tmax, seg_q, S, W,
                                  want_moves=with_moves, kernel=kernel)
            return out if with_moves else out[1:]
        return jax.jit(f)
    return make(False), make(True)


def time_fn(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def e2e_ab(n_reads=2000, genome_len=1_000_000):
    """pw -j 1 + cns stage walls on both DP paths, in one process.

    pw -j 0 (candidate scan) runs no DP, so it runs once, before the
    passes, and its candidates feed every cns pass."""
    import shutil

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from mecat_jax.ops.align import dp_path
    from mecat_jax.pipeline.cns import run_cns

    d = os.path.join(cs.WORK, "e2e_ab")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    db, _, reads = cs.simulate(d, cs.genome_of(genome_len), n_reads, 102)
    cand, _ = cs.pw_run(d, "j0", reads, db, 0)
    rows, outputs = [], {}
    for n, kernel in enumerate((False, True, False)):
        walls = cs.Walls()
        with dp_path(kernel=kernel):
            with walls("pw_j1"):
                _, j1 = cs.pw_run(d, f"j1_{n}", reads, db, 1)
            out = os.path.join(d, f"cns_{n}.fasta")
            with walls("cns"):
                run_cns(cand, reads, out, cs.cns_options(), db=db)
        recs = (sorted(j1), cs.fasta_records(out))
        if kernel in outputs and outputs[kernel] != recs:
            raise AssertionError("a path changed its own output")
        outputs[kernel] = recs
        row = dict(run=n, kernel=kernel, **walls.s)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if outputs[False] != outputs[True]:
        raise AssertionError("plain and kernel paths wrote different records")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=2048, help="DP pairs")
    ap.add_argument("--s", type=int, default=512)
    ap.add_argument("--w", default="128,64")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--e2e", action="store_true",
                    help="end-to-end pw + cns A/B instead of one segment")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from mecat_jax.utils.device import card_name_and_power_limit

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("roofline: no GPU (this tool measures the card)")
    card = card_name_and_power_limit()
    print(f"card: {card}", flush=True)
    if args.e2e:
        result = {"card": card, "device_kind": jax.devices()[0].device_kind,
                  "e2e": e2e_ab()}
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "roofline_e2e.json"),
                  "w") as fh:
            json.dump(result, fh, indent=1)
        print(json.dumps(result))
        return 0
    B, S = args.b, args.s
    rows = []
    for W in (int(w) for w in args.w.split(",")):
        q, t, tmax, seg_q = (jnp.asarray(a) for a in make_pairs(B, S, W))
        dev_args = (q, t, tmax, seg_q)
        for with_moves in (True, False):
            plain, kern = dp_fns(S, W, with_moves)
            for name, fn in (("plain", plain), ("kernel", kern)):
                mem = fn.lower(*dev_args).compile().memory_analysis()
                print(f"W={W} moves={with_moves} {name}: {mem}", flush=True)
            ref = jax.device_get(plain(*dev_args))
            got = jax.device_get(kern(*dev_args))
            for a, b in zip(ref, got):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            t_plain = time_fn(plain, dev_args, args.reps)
            t_kern = time_fn(kern, dev_args, args.reps)
            cells = B * S * W
            row = dict(W=W, S=S, B=B, with_moves=with_moves, equal=True,
                       plain_s=t_plain, kernel_s=t_kern,
                       plain_gcells_s=cells / t_plain / 1e9,
                       kernel_gcells_s=cells / t_kern / 1e9,
                       speedup=t_plain / t_kern)
            print(json.dumps(row), flush=True)
            rows.append(row)
    dev = jax.devices()[0]
    result = {"card": card, "device_kind": dev.device_kind, "dp": rows}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "roofline.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
