"""Chip smoke: mecat2pw -> mecat2cns -> mecat2ref once on the GPU.

Runs in one process that holds the card, through the entry points users
call (``run_pw``, ``run_cns``, ``run_ref``), and checks every result
against the repo's plain references:

  device   the default device is a GPU; the native host layer loaded
  dp       the CUDA DP kernel equals the plain XLA DP exactly (S=512,
           W=128 and 64, B=2048, with and without moves), both timed
  pw       a seeded PacBio-CLR simulation (1 Mb genome, 20x, ~2,000 reads
           of mean 10 kb, 12% error): ``-j 0`` candidates and ``-j 1`` M4
           on the device paths equal the host index build / host gather
  cns      ``correct_batch_device`` byte-equal to the host ``correct_batch``
           on 64 templates; the full ``run_cns`` median truth identity
           >= 99.0
  ref      200 reads mapped against the genome (SAM); every mapped read
           agrees with its true locus

Usage:
  python chip_smoke.py           the phases above, on one card
  python chip_smoke.py --four    four cards: ``run_pw_dist`` (data 2 x
                                 hash 2) and the template-sharded cns (on
                                 the first 512 reads), record-equal to the
                                 one-card runs
  python chip_smoke.py --full    the E. coli-scale set (4.6 Mb, 9,216
                                 reads): pw -j 0 -> cns stage walls and
                                 truth identity

Prints the card's name and power limit, stage walls and peak device memory,
and as its last line ``{"ok": true, "device": {...}}``.  A failed check
raises: the exit code is not 0 and no result line is printed.
"""
import argparse
import contextlib
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".artifacts", "chip_smoke")

#: the plain references of the device index build and the device gather
HOST_INDEX = {"MECAT_HOST_INDEX_BUILD": "1", "MECAT_PW_DEV_GATHER": "0"}


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def env(**kv):
    """Set environment variables for the enclosed calls, then restore."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Walls:
    """Stage wall times, printed as they finish."""

    def __init__(self):
        self.s = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        self.s[name] = time.perf_counter() - t0
        log(f"wall {name}: {self.s[name]:.3f} s")


def device_check(n_cards):
    import jax

    from mecat_jax import native
    from mecat_jax.utils.device import card_name_and_power_limit

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: default device is "
                         f"{devs[0].platform!r}, not a GPU")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: {len(devs)} GPU(s), need {n_cards}")
    log(f"card: {card_name_and_power_limit()}")
    log(f"device_kind: {devs[0].device_kind}, devices: {len(devs)}")
    log(f"bytes_limit: {devs[0].memory_stats()['bytes_limit']}")
    loaded = native.available()
    log(f"native host layer loaded: {loaded}")
    if not loaded:
        raise SystemExit("chip_smoke: the native host layer did not load")


def phase_dp(B=2048, S=512, reps=10):
    """Kernel vs plain DP, exact on every output, and both times."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import roofline

    for W in (128, 64):
        args = tuple(jnp.asarray(a) for a in roofline.make_pairs(B, S, W))
        for with_moves in (True, False):
            plain, kern = roofline.dp_fns(S, W, with_moves)
            mem = kern.lower(*args).compile().memory_analysis()
            log(f"dp W={W} moves={with_moves} kernel memory: {mem}")
            ref = jax.device_get(plain(*args))
            got = jax.device_get(kern(*args))
            for a, b in zip(ref, got):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            t_p = roofline.time_fn(plain, args, reps)
            t_k = roofline.time_fn(kern, args, reps)
            log(f"dp W={W} moves={with_moves}: equal; plain {t_p:.6f} s, "
                f"kernel {t_k:.6f} s (B={B}, S={S})")


def simulate(d, genome, n_reads, seed_reads):
    """Seeded PacBio-CLR reads of ``genome`` (mean 10 kb, min 3 kb, 12%
    error), written to FASTA."""
    import numpy as np

    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.utils.sim import simulate_reads

    db, truths = simulate_reads(genome, n_reads, mean_len=10000,
                                min_len=3000, seed=seed_reads,
                                error_rate=0.12)
    reads = os.path.join(d, f"reads_{seed_reads}.fasta")
    offs = np.concatenate([[0], np.cumsum(db.lengths)])
    write_fasta(reads, [(db.name(i), db.codes[offs[i]:offs[i + 1]])
                        for i in range(db.n_reads)])
    log(f"data: genome {len(genome)} bases, {db.n_reads} reads, "
        f"{int(db.lengths.sum())} bases")
    return db, truths, reads


def genome_of(n, seed=101):
    from mecat_jax.utils.sim import random_genome

    return random_genome(n, seed=seed)


def pw_run(d, name, reads, db, task):
    """One ``run_pw`` into a fresh work dir; returns the output lines."""
    from mecat_jax.pipeline.pw import PwOptions, run_pw

    out = os.path.join(d, f"{name}.txt")
    run_pw(reads, out, os.path.join(d, f"wrk_{name}"),
           PwOptions(task=task, num_candidates=100), db=db)
    with open(out) as fh:
        return out, fh.read().splitlines()


def assert_same_records(a, b, what):
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: {len(a)} vs {len(b)} records, "
                             f"{len(set(a) ^ set(b))} differ")
    if not a:
        raise AssertionError(f"{what}: no records")
    log(f"{what}: {len(a)} records equal")


def phase_pw(d, reads, db, walls):
    from mecat_jax.ops.align import use_dp_kernel
    from mecat_jax.pipeline import pw
    from mecat_jax.utils.device import on_accelerator

    taken = dict(accelerator=on_accelerator(), dp_kernel=use_dp_kernel(),
                 dev_gather=pw._use_dev_gather(),
                 fused=pw._use_fused(pw.PwOptions(task=1)))
    log(f"pw device paths: {taken}")
    if not all(taken.values()):
        raise AssertionError(f"device paths not taken: {taken}")
    with walls("pw_j0_device"):
        cand, j0 = pw_run(d, "j0_dev", reads, db, 0)
    with walls("pw_j1_device"):
        _, j1 = pw_run(d, "j1_dev", reads, db, 1)
    with env(**HOST_INDEX), walls("pw_j0_host"):
        _, j0_ref = pw_run(d, "j0_host", reads, db, 0)
    with env(MECAT_FORCE_FUSED="1", **HOST_INDEX), walls("pw_j1_host"):
        _, j1_ref = pw_run(d, "j1_host", reads, db, 1)
    assert_same_records(j0, j0_ref, "pw -j 0 device vs host candidates")
    assert_same_records(j1, j1_ref, "pw -j 1 device vs host M4")
    return cand


def cns_options(**overrides):
    from mecat_jax import constants as C
    from mecat_jax.pipeline.cns import CnsOptions

    return CnsOptions.for_tech(C.TECH_PACBIO, **overrides)


def phase_cns(d, cand, reads, db, genome, truths, walls, n_equal=64):
    import numpy as np

    from mecat_jax.pipeline import cns
    from mecat_jax.utils.accuracy import corrected_accuracy

    opts = cns_options()
    if cns._pick_correct_batch() is not cns.correct_batch_device:
        raise AssertionError("cns did not pick correct_batch_device")
    by_t = cns.load_supports(cand, db, 0)
    templates = sorted(by_t)[:n_equal]
    if len(templates) < n_equal:
        raise AssertionError(f"only {len(templates)} templates")
    with walls("cns_host_64"):
        host = dict(cns.correct_batch(db, templates, by_t, opts,
                                      cns.CnsStats()))
    with walls("cns_device_64"):
        dev = dict(cns.correct_batch_device(db, templates, by_t, opts,
                                            cns.CnsStats()))
    if set(host) != set(dev) or not host:
        raise AssertionError(f"cns reads differ: {len(host)} host, "
                             f"{len(dev)} device")
    for n in host:
        if not np.array_equal(host[n], dev[n]):
            raise AssertionError(f"cns read {n} differs device vs host")
    log(f"cns device vs host on {len(templates)} templates: "
        f"{len(host)} corrected reads byte-equal")
    out = os.path.join(d, "corrected.fasta")
    with walls("cns_run"):
        stats = cns.run_cns(cand, reads, out, opts, db=db)
    summ = corrected_accuracy(out, genome, truths).summary()
    log(f"cns: {stats.corrected_reads} corrected reads; accuracy {summ}")
    if summ.get("n", 0) == 0 or summ["median_identity"] < 99.0:
        raise AssertionError(f"cns median identity below 99.0: {summ}")
    return out


def phase_ref(d, genome, walls, n_reads=200):
    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.pipeline.ref import RefOptions, run_ref

    db, truths, reads = simulate(d, genome, n_reads, 303)
    ref_fa = os.path.join(d, "genome.fasta")
    write_fasta(ref_fa, [("chr_sim", genome)])
    sam = os.path.join(d, "ref.sam")
    with walls("ref_run"):
        run_ref(reads, ref_fa, sam, os.path.join(d, "wrk_ref"),
                RefOptions(output_format="sam"), db=db)
    pos = {}
    with open(sam) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.split("\t")
            if int(f[1]) & 0x904:   # unmapped / secondary / supplementary
                continue
            pos[f[0]] = int(f[3]) - 1
    bad = [i for i, t in enumerate(truths) if db.name(i) in pos
           and not t.start - 2000 <= pos[db.name(i)] <= t.end + 2000]
    log(f"ref: {len(pos)}/{n_reads} mapped, {len(bad)} off their true locus")
    if bad or len(pos) < 0.9 * n_reads:
        raise AssertionError(f"ref: {len(pos)} mapped, off locus: {bad[:10]}")


def peak_memory():
    import jax

    return {str(d.id): d.memory_stats().get("peak_bytes_in_use")
            for d in jax.local_devices()}


def run_one_card(walls):
    phase_dp()
    d = WORK
    with walls("simulate"):
        genome = genome_of(1_000_000)
        db, truths, reads = simulate(d, genome, 2000, 102)
    cand = phase_pw(d, reads, db, walls)
    phase_cns(d, cand, reads, db, genome, truths, walls)
    phase_ref(d, genome, walls)


def run_four(walls, genome_len=1_000_000, n_reads=2000, cns_reads=512):
    """run_pw_dist (data 2 x hash 2) and run_cns_dist over four cards vs
    the one-card run_pw -j 1 and run_cns, on the pw phase's data.  The cns
    pair corrects the first ``cns_reads`` reads from the -j 1 M4 (the
    overlaps among them), which keeps the four-card run short."""
    from mecat_jax.parallel.cns_dist import run_cns_dist
    from mecat_jax.parallel.dist import run_pw_dist
    from mecat_jax.pipeline.cns import run_cns
    from mecat_jax.pipeline.pw import PwOptions

    d = WORK
    with walls("simulate"):
        db, _, reads = simulate(d, genome_of(genome_len), n_reads, 102)
    with walls("pw_j1_one_card"):
        _, j1 = pw_run(d, "j1", reads, db, 1)
    out = os.path.join(d, "j1_dist.m4")
    with walls("pw_j1_four_cards"):
        run_pw_dist(reads, out, os.path.join(d, "wrk_dist"),
                    PwOptions(task=1, num_candidates=100), n_data=2,
                    n_hash=2, db=db)
    with open(out) as fh:
        assert_same_records(fh.read().splitlines(), j1,
                            "pw -j 1 four cards vs one card")
    sub = os.path.join(d, "j1_sub.m4")
    with open(sub, "w") as fh:
        for line in j1:
            f = line.split()
            if int(f[0]) < cns_reads and int(f[1]) < cns_reads:
                fh.write(line + "\n")
    opts = cns_options(input_type=1)
    one = os.path.join(d, "cns_one.fasta")
    four = os.path.join(d, "cns_four.fasta")
    with walls("cns_one_card"):
        run_cns(sub, reads, one, opts, db=db)
    with walls("cns_four_cards"):
        run_cns_dist(sub, reads, four, os.path.join(d, "wrk_cns_dist"),
                     opts, n_data=4, db=db)
    assert_same_records(fasta_records(four), fasta_records(one),
                        "cns four cards vs one card")


def fasta_records(path):
    from mecat_jax.io.fasta import iter_fasta

    return [(r.name, r.codes.tobytes()) for r in iter_fasta(path)]


def run_full(walls):
    """The E. coli-scale set of tools/ecoli_e2e.py (seeds 101/102)."""
    from mecat_jax.utils.accuracy import corrected_accuracy

    d = WORK
    with walls("simulate"):
        genome = genome_of(4_600_000)
        db, truths, reads = simulate(d, genome, 9216, 102)
    with walls("pw_j0"):
        cand, _ = pw_run(d, "j0", reads, db, 0)
    from mecat_jax.pipeline.cns import run_cns

    out = os.path.join(d, "corrected.fasta")
    with walls("cns"):
        stats = run_cns(cand, reads, out, cns_options(), db=db)
    summ = corrected_accuracy(out, genome, truths).summary()
    log(f"full: {stats.corrected_reads} corrected reads; accuracy {summ}")
    if summ.get("n", 0) == 0 or summ["median_identity"] < 99.0:
        raise AssertionError(f"full: median identity below 99.0: {summ}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true",
                      help="the four-card path and its one-card reference")
    mode.add_argument("--full", action="store_true",
                      help="the E. coli-scale set (builder's run)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import mecat_jax  # noqa: F401
    except ImportError:
        sys.exit("chip_smoke: run from the root of a checkout of the repo")
    import jax

    n_cards = 4 if args.four else 1
    device_check(n_cards)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    walls = Walls()
    if args.four:
        run_four(walls)
    elif args.full:
        run_full(walls)
    else:
        run_one_card(walls)
    log(f"stage walls (s): {json.dumps(walls.s)}")
    log(f"peak device memory (bytes): {json.dumps(peak_memory())}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
