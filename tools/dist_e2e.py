"""Config-5 evidence: the DISTRIBUTED drivers at data scale on the virtual
CPU mesh, byte-compared to the single-chip paths (VERDICT r4 next #7).

The toy dist tests (tests/test_dist.py, 32 reads) prove plumbing; this
tool runs the same multi-controller drivers over a yeast-chromosome-scale
simulated dataset (default 1.5 Mb genome, 15x, mean 5 kb — thousands of
reads, tens of thousands of overlaps) and asserts exact record equality:

  pw : run_pw_dist over 2 REAL processes x 4 virtual CPU devices
       (localhost jax.distributed coordinator) == single-driver fused
       run_pw, record-for-record.
  cns: run_cns_dist (2 x 4) == single-driver run_cns, corrected FASTA
       record-for-record (support table subset bounded for 1-core wall).

Writes evidence JSON to --out.  On virtual CPU devices the wall is hours
— it is a correctness run, not a perf run (the mesh "devices" share the
host's cores).

Usage: python tools/dist_e2e.py [--dir .artifacts/dist_e2e]
       [--genome 1500000] [--cov 15] [--stage pw|cns|all]
Internal: --worker pw|cns --port P --nproc N --pid K --dir D
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PW_OPTS = dict(task=1, kmer_size=13, scan_stride=10, num_candidates=16,
               max_occ=16, min_align_size=2000, min_identity=70.0,
               align_segment=512, align_band=128)
CNS_OPTS = dict(min_length=2000, extend_batch=64)
CNS_TEMPLATE_CAP = 768          # reads whose piles enter the cns legs


def _pw_options():
    from mecat_jax.pipeline.pw import PwOptions

    return PwOptions(**PW_OPTS)


def _cns_options():
    from mecat_jax import constants as C
    from mecat_jax.pipeline.cns import CnsOptions

    return CnsOptions.for_tech(C.TECH_PACBIO, **CNS_OPTS)


def _m4_records(path):
    with open(path) as fh:
        return sorted(ln.split() for ln in fh if ln.strip())


def _fasta_records(path):
    from mecat_jax.io.fasta import iter_fasta

    return sorted((r.name, r.codes.tobytes()) for r in iter_fasta(path))


def worker(args):
    # env BEFORE any jax import
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{args.port}"
    os.environ["JAX_NUM_PROCESSES"] = str(args.nproc)
    os.environ["JAX_PROCESS_ID"] = str(args.pid)
    d = args.dir
    if args.worker == "pw":
        from mecat_jax.parallel.dist import run_pw_dist

        stats = run_pw_dist(os.path.join(d, "reads.fasta"),
                            os.path.join(d, "dist_mp.m4"),
                            os.path.join(d, "wrk_mp"), _pw_options(),
                            n_data=4, n_hash=2)
        print(f"worker {args.pid}: {stats.overlaps} overlaps", flush=True)
    else:
        from mecat_jax.parallel.cns_dist import run_cns_dist

        stats = run_cns_dist(os.path.join(d, "cand_sub.txt"),
                             os.path.join(d, "reads.fasta"),
                             os.path.join(d, "dist_mp.fasta"),
                             os.path.join(d, "wrk_mp_cns"), _cns_options(),
                             n_data=8)
        print(f"worker {args.pid}: {stats.corrected_reads} corrected",
              flush=True)
    return 0


def spawn_workers(mode, d, nproc=2):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", mode,
         "--port", str(port), "--nproc", str(nproc), "--pid", str(p),
         "--dir", d],
        env=env, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        for p in range(nproc)][::-1]
    rcs = [p.wait() for p in procs]
    assert all(rc == 0 for rc in rcs), rcs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=".artifacts/dist_e2e")
    ap.add_argument("--genome", type=int, default=1_500_000)
    ap.add_argument("--cov", type=float, default=15.0)
    ap.add_argument("--mean-len", type=int, default=5000)
    ap.add_argument("--stage", default="all", choices=("pw", "cns", "all"))
    ap.add_argument("--out", default=".artifacts/dist_e2e/summary.json")
    # worker plumbing
    ap.add_argument("--worker", choices=("pw", "cns"))
    ap.add_argument("--port", type=int)
    ap.add_argument("--nproc", type=int)
    ap.add_argument("--pid", type=int)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    d = args.dir
    os.makedirs(d, exist_ok=True)
    summary = {"genome": args.genome, "cov": args.cov}

    import numpy as np

    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.utils.sim import random_genome, simulate_reads

    n_reads = int(args.genome * args.cov / args.mean_len)
    genome = random_genome(args.genome, seed=301)
    db, _ = simulate_reads(genome, n_reads, mean_len=args.mean_len,
                           min_len=2000, seed=302, error_rate=0.12)
    reads = os.path.join(d, "reads.fasta")
    if not os.path.exists(reads):
        offs = np.concatenate([[0], np.cumsum(db.lengths)])
        write_fasta(reads, [(db.name(i), db.codes[offs[i]:offs[i + 1]])
                            for i in range(db.n_reads)])
    summary.update(reads=int(db.n_reads), bases=int(db.lengths.sum()))
    print(f"dist_e2e: {summary}", flush=True)

    if args.stage in ("pw", "all"):
        single = os.path.join(d, "single.m4")
        if not os.path.exists(single):
            os.environ["MECAT_FORCE_FUSED"] = "1"
            from mecat_jax.pipeline.pw import run_pw

            t0 = time.time()
            run_pw(reads, single, os.path.join(d, "wrk_single"),
                   _pw_options(), db=db)
            summary["pw_single_s"] = round(time.time() - t0, 1)
            del os.environ["MECAT_FORCE_FUSED"]
        t0 = time.time()
        spawn_workers("pw", d)
        summary["pw_dist_s"] = round(time.time() - t0, 1)
        s, m = _m4_records(single), _m4_records(os.path.join(d, "dist_mp.m4"))
        summary["pw_records"] = len(m)
        summary["pw_equal"] = s == m
        print(f"dist_e2e: pw {len(m)} records, equal={s == m}", flush=True)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)     # incremental evidence
        assert s == m and len(m) > 1000, (len(s), len(m))

    if args.stage in ("cns", "all"):
        # candidates for the cns legs: a task-0 staged run, subset to the
        # first CNS_TEMPLATE_CAP reads' piles (1-core wall bound)
        cand = os.path.join(d, "cand.txt")
        if not os.path.exists(cand):
            from mecat_jax.pipeline.pw import PwOptions, run_pw

            opts0 = PwOptions(**{**PW_OPTS, "task": 0})
            t0 = time.time()
            run_pw(reads, cand, os.path.join(d, "wrk_cand"), opts0, db=db)
            summary["pw_cand_s"] = round(time.time() - t0, 1)
        cand_sub = os.path.join(d, "cand_sub.txt")
        if not os.path.exists(cand_sub):
            cap = CNS_TEMPLATE_CAP
            with open(cand) as fi, open(cand_sub, "w") as fo:
                for ln in fi:
                    f = ln.split()
                    if f and int(f[0]) <= cap and int(f[1]) <= cap:
                        fo.write(ln)
        single_f = os.path.join(d, "single.fasta")
        if not os.path.exists(single_f):
            from mecat_jax.pipeline.cns import run_cns

            t0 = time.time()
            run_cns(cand_sub, reads, single_f, _cns_options(), db=db)
            summary["cns_single_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        spawn_workers("cns", d)
        summary["cns_dist_s"] = round(time.time() - t0, 1)
        s = _fasta_records(single_f)
        m = _fasta_records(os.path.join(d, "dist_mp.fasta"))
        summary["cns_records"] = len(m)
        summary["cns_equal"] = s == m
        print(f"dist_e2e: cns {len(m)} records, equal={s == m}", flush=True)
        assert s == m and len(m) > 100, (len(s), len(m))

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
