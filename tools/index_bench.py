"""Device k-mer index build breakdown (VERDICT r3 weak #5 / next #7).

Measures, on the real chip, where build_index's wall time goes at a chosen
scale: host sim, 2-bit upload, the big counting-sort jit's COMPILE time
(lower().compile(), which is the cold-cache cost) vs EXECUTE time, and the
small follow-up programs (valid-prefix slices, position reconstruction).

Usage:
  python tools/index_bench.py [--reads 9216] [--genome 4600000] [--cold]

--cold redirects the persistent compile cache to a throwaway dir BEFORE
jax/mecat_jax import, so the measurement shows true cold-compile cost
without poisoning (or benefiting from) the shared cache.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=9216)
    ap.add_argument("--genome", type=int, default=4_600_000)
    ap.add_argument("--mean-len", type=int, default=10_000)
    ap.add_argument("--k", type=int, default=13)
    ap.add_argument("--cold", action="store_true",
                    help="throwaway compile cache (true cold measurement)")
    args = ap.parse_args(argv)

    if args.cold:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
            prefix="mecat_idx_cold_")

    import mecat_jax  # noqa: F401  (configures cache/platform)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mecat_jax.index.kmer_index import _build_index_device_jit
    from mecat_jax.io.packed_db import upload_codes
    from mecat_jax.utils.sim import random_genome, simulate_reads

    out = {"cold": bool(args.cold), "k": args.k,
           "platform": jax.devices()[0].platform}

    t0 = time.time()
    genome = random_genome(args.genome, seed=101)
    db, _ = simulate_reads(genome, args.reads, mean_len=args.mean_len,
                           min_len=3000, seed=102, error_rate=0.12)
    out["sim_s"] = round(time.time() - t0, 1)
    out["bases"] = int(db.lengths.sum())

    n = len(db.codes)
    p = 1 << max(14, (n - 1).bit_length())
    n_pad = p if n > 3 * p // 4 else 3 * p // 4

    t0 = time.time()
    codes_dev = upload_codes(np.asarray(db.codes, dtype=np.uint8), n_pad)
    np.asarray(codes_dev[0])  # wait for the transfer to finish
    out["upload_s"] = round(time.time() - t0, 1)

    starts = jnp.asarray(db.starts.astype(np.int32))
    lengths = jnp.asarray(db.lengths.astype(np.int32))

    t0 = time.time()
    lowered = _build_index_device_jit.lower(codes_dev, starts, lengths,
                                            k=args.k)
    out["trace_lower_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    compiled = lowered.compile()
    out["compile_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    offsets, rid_s, loc_s, n_valid, n_distinct = compiled(
        codes_dev, starts, lengths)
    n_valid_i = int(n_valid)          # host sync
    out["execute_s"] = round(time.time() - t0, 1)
    out["positions"] = n_valid_i

    # the small follow-up programs build_index runs after the big jit
    t0 = time.time()
    pos_rid = rid_s[:n_valid_i]
    pos_loc = loc_s[:n_valid_i]
    positions = (starts[pos_rid] + pos_loc).astype(jnp.int32)
    np.asarray(positions[0])
    out["tail_programs_s"] = round(time.time() - t0, 1)
    out["total_s"] = round(sum(v for k, v in out.items()
                               if isinstance(v, float)), 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
