"""Subprocess worker for the 2-process jax.distributed tests.

Invoked as ``python tests/dist_worker.py <port> <nproc> <pid> <datadir>
[mode]`` with JAX_PLATFORMS=cpu and 4 virtual devices per process.
mode "pw" (default) runs run_pw_dist → dist_mp.m4;
mode "cns" runs run_cns_dist → dist_mp.fasta (rank 0 merges).
"""
import os
import sys


def main():
    port, nproc, pid, d = sys.argv[1:5]
    mode = sys.argv[5] if len(sys.argv) > 5 else "pw"
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["JAX_NUM_PROCESSES"] = nproc
    os.environ["JAX_PROCESS_ID"] = pid

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    if mode == "pw":
        from mecat_jax.parallel.dist import run_pw_dist
        from mecat_jax.pipeline.pw import PwOptions

        opts = PwOptions(task=1, kmer_size=9, scan_stride=4,
                         min_align_size=500, num_candidates=8, scan_batch=4,
                         extend_batch=64, align_segment=128, align_band=64,
                         min_block_score=2)
        stats = run_pw_dist(os.path.join(d, "reads.fasta"),
                            os.path.join(d, "dist_mp.m4"),
                            os.path.join(d, "wrk_mp"), opts,
                            n_data=4, n_hash=2)
        print(f"worker {pid}: {stats.overlaps} overlaps", flush=True)
    elif mode == "cns":
        from mecat_jax.parallel.cns_dist import run_cns_dist
        from mecat_jax.pipeline.cns import CnsOptions

        opts = CnsOptions(min_align_size=300, min_length=500,
                          min_mapping_ratio=0.3, align_segment=128,
                          align_band=64, extend_batch=32, min_identity=65.0)
        stats = run_cns_dist(os.path.join(d, "cand.txt"),
                             os.path.join(d, "reads.fasta"),
                             os.path.join(d, "dist_mp.fasta"),
                             os.path.join(d, "wrk_mp_cns"), opts, n_data=8)
        print(f"worker {pid}: {stats.corrected_reads} corrected", flush=True)
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
