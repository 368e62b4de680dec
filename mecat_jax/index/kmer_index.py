"""Device-friendly k-mer index (L2 of SURVEY.md §1).

Counterpart of the reference ``build_lookup_table`` (SURVEY.md §2.1 component 1,
``src/common/lookup_table.*`` — unverified, mount empty).  The reference uses a
chained hash table probed one k-mer at a time by pthread workers; on device the
same contract — k-mer → list of occurrence positions, with high-frequency
k-mers dropped — is served by a **direct-address CSR table**:

* ``offsets``: int32[4^k + 1], prefix sums of per-k-mer occurrence counts
  (direct addressing — the k-mer's 2k-bit integer code is the slot index),
* ``positions``: int32[M], global base positions sorted by k-mer code.

Probing is a fixed-shape vectorized gather: ``off = offsets[code]``,
``cnt = offsets[code+1] - off``, then gather ``positions[off + j]`` for
``j < min(cnt, MAX_OCC)``.  High-frequency k-mers are dropped at probe time
by masking slots whose count exceeds the cutoff — identical selectivity to
dropping them at build, but keeps the build a pure counting sort.

The index is built host-side with NumPy counting-sort primitives (bincount +
stable argsort) and uploaded to HBM once per volume; probes run on device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..utils.device import on_accelerator


def kmer_codes_np(codes: np.ndarray, k: int) -> np.ndarray:
    """k-mer integer codes at every start position (host build path).

    Returns int64[N] where out[p] encodes bases[p:p+k] big-endian (base p is
    the most significant 2 bits).  Positions closer than k to the end of the
    array hold garbage; validity is handled by the caller via read bounds.
    """
    n = len(codes)
    out = np.zeros(n, dtype=np.int64)
    c = codes.astype(np.int64)
    for j in range(k):
        shifted = np.zeros(n, dtype=np.int64)
        shifted[: n - j] = c[j:]
        out = (out << 2) | shifted
    return out


def kmer_codes_jnp(bases: jnp.ndarray, k: int) -> jnp.ndarray:
    """Same encoding as :func:`kmer_codes_np`, on device, over [..., L] bases.

    Uses int32 when 2k <= 31 (always true for k <= 15, MECAT's range).
    """
    assert 2 * k <= 31, "k too large for int32 codes"
    L = bases.shape[-1]
    out = jnp.zeros(bases.shape, dtype=jnp.int32)
    b = bases.astype(jnp.int32)
    for j in range(k):
        shifted = jnp.zeros_like(b).at[..., : L - j].set(b[..., j:]) if j else b
        out = (out << 2) | shifted
    return out


@dataclass
class KmerIndex:
    """CSR direct-address k-mer table over one packed volume (or a genome).

    Occurrences are stored pre-resolved as (read id, local offset) pairs —
    ``pos_rid``/``pos_loc`` — rather than global base positions: resolving
    1-2M hit positions per batch with a device binary search
    (``global_to_read``) costs far more than one extra direct gather, so
    the global→read mapping is paid once at build time on the host instead
    of on every probe.  ``positions`` (global,
    sorted by k-mer code) is kept for persistence/debug and hash-sharding.
    """

    k: int
    offsets: np.ndarray        # int32 [4^k + 1]
    positions: np.ndarray      # int32 [M] global positions, sorted by k-mer
    pos_rid: np.ndarray        # int32 [M] read id of each occurrence
    pos_loc: np.ndarray        # int32 [M] offset within the read
    read_starts: np.ndarray    # int32 [n_reads] (volume < 2^31 bases)
    read_lengths: np.ndarray   # int32 [n_reads]
    max_occ_cutoff: int        # slots with more occurrences are dropped

    @property
    def n_reads(self) -> int:
        return len(self.read_starts)

    def as_device_arrays(self):
        """Upload the probe-side arrays once; returns a dict of jnp arrays."""
        return dict(
            offsets=jnp.asarray(self.offsets),
            pos_rid=jnp.asarray(self.pos_rid),
            pos_loc=jnp.asarray(self.pos_loc),
            read_starts=jnp.asarray(self.read_starts),
            read_lengths=jnp.asarray(self.read_lengths),
        )


def build_index(codes: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                k: int = C.KMER_SIZE,
                freq_cutoff_multiple: float = C.KMER_FREQ_CUTOFF_MULTIPLE,
                freq_cutoff_abs: int | None = None,
                device: bool | None = None,
                codes_dev=None) -> KmerIndex:
    """Build the CSR k-mer table over a volume's flat code array.

    Every position of every read contributes its k-mer (index-side stride 1,
    matching the reference lookup table); k-mers spanning a read boundary are
    excluded.

    The build is a counting sort; on an accelerator it runs ON DEVICE
    (:func:`_build_index_device` — one stable ``lax.sort`` + scatter-add),
    on the CPU backend (or with MECAT_HOST_INDEX_BUILD=1) in NumPy.
    Both paths produce identical arrays (both sorts are stable on original
    position order; tests/test_kmer_index.py).
    """
    if device is None:
        device = (os.environ.get("MECAT_HOST_INDEX_BUILD") != "1"
                  and on_accelerator())
    if device and len(codes):
        return _build_index_device(codes, starts, lengths, k,
                                   freq_cutoff_multiple, freq_cutoff_abs,
                                   codes_dev=codes_dev)
    n_slots = 1 << (2 * k)
    starts = starts.astype(np.int64)
    lengths = lengths.astype(np.int64)
    n = len(codes)

    all_codes = kmer_codes_np(np.asarray(codes, dtype=np.uint8), k)
    # valid iff the k-mer fits inside its read
    read_ids = np.repeat(np.arange(len(starts), dtype=np.int64), lengths)
    local = np.arange(n, dtype=np.int64) - starts[read_ids]
    valid = local <= (lengths[read_ids] - k)
    vpos = np.nonzero(valid)[0]
    vcodes = all_codes[vpos]

    counts = np.bincount(vcodes, minlength=n_slots)
    offsets = np.zeros(n_slots + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    order = np.argsort(vcodes, kind="stable")
    positions = vpos[order].astype(np.int32)

    mean_occ = max(1.0, len(vcodes) / max(1, np.count_nonzero(counts)))
    cutoff = (int(freq_cutoff_abs) if freq_cutoff_abs is not None
              else max(int(mean_occ * freq_cutoff_multiple),
                       C.MAX_OCC_PER_KMER))
    assert offsets[-1] == len(positions)
    pos_rid = (np.searchsorted(starts, positions.astype(np.int64),
                               side="right") - 1).astype(np.int32)
    pos_loc = (positions.astype(np.int64) - starts[pos_rid]).astype(np.int32)
    return KmerIndex(k=k, offsets=offsets.astype(np.int32),
                     positions=positions, pos_rid=pos_rid, pos_loc=pos_loc,
                     read_starts=starts.astype(np.int32),
                     read_lengths=lengths.astype(np.int32),
                     max_occ_cutoff=cutoff)


@partial(jax.jit, static_argnames=("k",))
def _build_index_device_jit(codes: jnp.ndarray, starts: jnp.ndarray,
                            lengths: jnp.ndarray, k: int):
    """Device counting-sort index build over the flat volume.

    Returns (offsets[4^k+1], rid_s[n], loc_s[n], n_valid, n_distinct) where
    only the first n_valid entries of rid_s/loc_s are meaningful (the CSR
    offsets never index past them — invalid k-mers sort to the tail).
    """
    n = codes.shape[0]
    n_slots = 1 << (2 * k)
    c = kmer_codes_jnp(codes[None, :], k)[0]                   # int32 [n]
    # read id per base: unit scatter at read starts, cumsum
    rid = (jnp.cumsum(jnp.zeros(n, jnp.int32).at[starts].add(1)) - 1
           ).astype(jnp.int32)
    loc = (jnp.arange(n, dtype=jnp.int32) - starts[rid]).astype(jnp.int32)
    valid = loc <= (lengths[rid] - k)
    key = jnp.where(valid, c, n_slots)       # sentinel sorts to the tail
    # stable sort == NumPy path's stable argsort by (code, position)
    key_s, rid_s, loc_s = jax.lax.sort((key, rid, loc), num_keys=1)
    counts = jnp.zeros(n_slots, jnp.int32).at[
        jnp.where(valid, c, 0)].add(valid.astype(jnp.int32))
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)])
    n_valid = jnp.sum(valid.astype(jnp.int32))
    n_distinct = jnp.sum((counts > 0).astype(jnp.int32))
    return offsets, rid_s, loc_s, n_valid, n_distinct


def _build_index_device(codes, starts, lengths, k,
                        freq_cutoff_multiple,
                        freq_cutoff_abs=None, codes_dev=None) -> KmerIndex:
    """Device build; the big arrays STAY on device (jnp) — consumers probe
    them in place instead of pulling 4^k offsets back to the host.  Only
    two scalars sync."""
    starts32 = np.asarray(starts, dtype=np.int32)
    lengths32 = np.asarray(lengths, dtype=np.int32)
    # bucket the flat length so volumes of different sizes reuse the same
    # compiled build (first compile is expensive; shapes are jit keys).
    # Buckets are powers of two and their 1.5x midpoints: <= 33% padding.
    n = len(codes)
    p = 1 << max(14, (n - 1).bit_length())
    n_pad = p if n > 3 * p // 4 else 3 * p // 4
    from ..io.packed_db import upload_codes

    # 2-bit packed upload (tail zeros belong to no read => invalid).
    # A caller holding the codes on device already (e.g. run_pw's oriented
    # query volume) passes codes_dev: padding happens on device and the
    # upload is skipped entirely.
    if codes_dev is not None:
        codes_dev = jnp.concatenate(
            [codes_dev[:n].astype(jnp.uint8),
             jnp.zeros(n_pad - n, dtype=jnp.uint8)])
    else:
        codes_dev = upload_codes(np.asarray(codes, dtype=np.uint8), n_pad)
    offsets, rid_s, loc_s, n_valid, n_distinct = _build_index_device_jit(
        codes_dev, jnp.asarray(starts32), jnp.asarray(lengths32), k)
    n_valid = int(n_valid)
    pos_rid = rid_s[:n_valid]
    pos_loc = loc_s[:n_valid]
    positions = (jnp.asarray(starts32)[pos_rid] + pos_loc).astype(jnp.int32)
    mean_occ = max(1.0, n_valid / max(1, int(n_distinct)))
    cutoff = (int(freq_cutoff_abs) if freq_cutoff_abs is not None
              else max(int(mean_occ * freq_cutoff_multiple),
                       C.MAX_OCC_PER_KMER))
    return KmerIndex(k=k, offsets=offsets, positions=positions,
                     pos_rid=pos_rid, pos_loc=pos_loc,
                     read_starts=starts32, read_lengths=lengths32,
                     max_occ_cutoff=cutoff)


@partial(jax.jit, static_argnames=("max_occ",))
def probe_index(offsets: jnp.ndarray, pos_rid: jnp.ndarray,
                pos_loc: jnp.ndarray, query_codes: jnp.ndarray,
                query_valid: jnp.ndarray, cutoff: jnp.ndarray,
                max_occ: int = C.MAX_OCC_PER_KMER):
    """Vectorized index probe.

    Args:
      offsets, pos_rid, pos_loc: device CSR arrays (pre-resolved occurrences).
      query_codes: int32[..., Q] k-mer codes to look up.
      query_valid: bool[..., Q] validity of each code.
      cutoff: scalar int32; slots with count > cutoff are dropped entirely
        (high-frequency k-mer filtering, SURVEY.md §2.1).
      max_occ: static cap on occurrences gathered per k-mer.

    Returns:
      hit_rid: int32[..., Q, max_occ] read id (0 where invalid)
      hit_loc: int32[..., Q, max_occ] offset within the read
      hit_valid: bool[..., Q, max_occ]
    """
    codes = jnp.where(query_valid, query_codes, 0)
    off = offsets[codes]
    cnt = offsets[codes + 1] - off
    keep = query_valid & (cnt <= cutoff)
    cnt = jnp.where(keep, jnp.minimum(cnt, max_occ), 0)
    j = jnp.arange(max_occ, dtype=jnp.int32)
    idx = off[..., None] + j  # [..., Q, max_occ]
    hit_valid = j < cnt[..., None]
    idx = jnp.where(hit_valid, idx, 0)
    return pos_rid[idx], pos_loc[idx], hit_valid


def global_to_read(read_starts: jnp.ndarray, read_lengths: jnp.ndarray,
                   gpos: jnp.ndarray):
    """Map global base positions → (read_id, local_offset) via binary search."""
    rid = jnp.searchsorted(read_starts, gpos, side="right") - 1
    rid = jnp.clip(rid, 0, read_starts.shape[0] - 1).astype(jnp.int32)
    return rid, gpos - read_starts[rid]
