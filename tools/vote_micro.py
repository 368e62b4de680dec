"""Micro-decomposition of the cns vote (call_tables): where do 3.4 s/slice go?

Times, at full-scale slice shapes (T templates x L_t x D1 x 5 counts), the
full call_tables plus its pieces in isolation: self-vote scatter-add,
run-pooled deletions, run/window-pooled insertions, and the emit packing.
Run on the real chip.

Usage: python tools/vote_micro.py [--t 108] [--lt 16384] [--reps 3]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def timeit(fn, reps):
    fn()  # warm/compile
    t0 = time.time()
    for _ in range(reps):
        fn()
    return (time.time() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=108)
    ap.add_argument("--lt", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from mecat_jax import constants as C
    from mecat_jax.ops.consensus_device import (
        call_tables, pack_emit_cov, _run_pooled_deletions_dev,
        _run_pooled_insertions_dev, _window_pooled_insertions_dev)

    T, L = args.t, args.lt
    D1 = C.MAX_INS_DELTA + 1
    rng = np.random.default_rng(7)
    counts_h = rng.integers(0, 3, size=(T, L, D1, 5), dtype=np.int32)
    counts_h[:, :, 0, :] += rng.integers(0, 20, size=(T, L, 5)).astype(np.int32)
    cov_h = np.zeros((T, L + 1), np.int32)
    cov_h[:, 0] = 25
    cov_h[:, -1] = -25
    tmpl_h = rng.integers(0, 4, size=(T, L)).astype(np.uint8)
    tlen_h = np.full(T, L - 64, np.int32)
    counts = jnp.asarray(counts_h)
    cov_diff = jnp.asarray(cov_h)
    tmpl = jnp.asarray(tmpl_h)
    tlen = jnp.asarray(tlen_h)
    has = jnp.ones(T, bool)
    coverage = jnp.cumsum(cov_diff[:, :L], axis=1)

    def sync(x):
        np.asarray(x.reshape(-1)[0])

    def f_call():
        emit, cov_ok = call_tables(counts, cov_diff, tmpl, tlen, has,
                                   jnp.int32(4))
        sync(emit)

    def f_call_and_pack():
        emit, cov_ok = call_tables(counts, cov_diff, tmpl, tlen, has,
                                   jnp.int32(4))
        n_ins = jnp.max(jnp.sum((emit[:, :, 1:] >= 0).astype(jnp.int32),
                                axis=2))
        k = int(n_ins)
        packed, cbits = pack_emit_cov(emit, cov_ok, k + 1)
        sync(packed)

    dels = jax.jit(lambda c, cov: _run_pooled_deletions_dev(
        tmpl.astype(jnp.int32), c, cov, tlen, 1))
    inse = jax.jit(lambda c, cov: _run_pooled_insertions_dev(
        tmpl.astype(jnp.int32), c, cov,
        jnp.zeros((T, L, D1 - 1), bool), jnp.zeros((T, L, D1 - 1), jnp.int32),
        tlen, 1))
    wins = jax.jit(lambda c, cov: _window_pooled_insertions_dev(
        c, cov, jnp.full((T, L, D1 - 1), -1, jnp.int32),
        jnp.ones((T, L), bool)))
    selfvote = jax.jit(lambda c: c.at[
        jnp.arange(T)[:, None], jnp.arange(L)[None, :], 0,
        tmpl.astype(jnp.int32)].add(1))

    out = {"T": T, "L": L}
    for name, fn in (
            ("t_call_tables_s", f_call),
            ("t_call_plus_pack_s", f_call_and_pack),
            ("t_del_pool_s", lambda: sync(dels(counts, coverage))),
            ("t_ins_pool_s", lambda: sync(inse(counts, coverage))),
            ("t_win_pool_s", lambda: sync(wins(counts, coverage))),
            ("t_self_vote_s", lambda: sync(selfvote(counts)))):
        out[name] = round(timeit(fn, args.reps), 3)
        print(name, out[name], flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
