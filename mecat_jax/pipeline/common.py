"""Shared host-side batching helpers for the pipeline drivers."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .. import constants as C
from ..io.packed_db import _REVCOMP, PackedDB
from ..ops.align import Q_SENTINEL, T_SENTINEL


def bucket_length(n: int, minimum: int = 1024, pow2: bool = False) -> int:
    """Padded length >= n from a coarse bucket ladder (powers of two and
    their 1.5x midpoints, multiples of 1024; ``pow2=True`` drops the
    midpoints).

    Shapes are jit keys and compiles are expensive: per-batch max-length
    padding caused a recompile for nearly every batch, so lengths snap to
    O(log) buckets at <= 33% padding waste instead.  The cns table path
    uses the pow2-only ladder: each bucket compiles a whole program
    family, and halving the bucket count beats the
    extra ~9% padding on the table ops.
    """
    n = max(n, minimum)
    p = 1 << max(10, (n - 1).bit_length())
    b = p if (pow2 or n > 3 * p // 4) else 3 * p // 4
    return max(minimum, int(math.ceil(b / 1024)) * 1024)


def oriented_batch(db: PackedDB, read_ids: Sequence[int], L: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather reads in both orientations, padded to L.

    Returns (fwd[B, L], rev[B, L], lengths[B]).  Padding value 0 — callers
    that feed the aligner must re-pad with sentinels (extend_pair_batch masks
    tails itself).
    """
    fwd, lens = db.padded_batch(read_ids, pad_to=L)
    # vectorised batched revcomp: rev[i, j] = comp(fwd[i, lens[i]-1-j]);
    # the per-read Python loop was a real per-batch host cost.
    idx = lens[:, None].astype(np.int64) - 1 - np.arange(L, dtype=np.int64)
    valid = idx >= 0
    comp = _REVCOMP[np.take_along_axis(fwd, np.maximum(idx, 0), axis=1)]
    rev = np.where(valid, comp, 0).astype(np.uint8)
    return fwd, rev, lens


def gather_rows(flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                ids: np.ndarray, L: int, fill: int = 0) -> np.ndarray:
    """Vectorised ragged gather: rows[i] = flat[starts[ids[i]] : +lengths], padded."""
    ids = np.asarray(ids, dtype=np.int64)
    lens = lengths[ids].astype(np.int64)
    idx = starts[ids][:, None] + np.arange(L, dtype=np.int64)[None, :]
    mask = np.arange(L, dtype=np.int64)[None, :] < lens[:, None]
    idx = np.where(mask, idx, 0)
    out = flat[idx]
    out[~mask] = fill
    return out


def device_query_volume(db: PackedDB, read_range=None):
    """Device-resident oriented volume for QUERY-row gathers.

    The staged/fused pw dispatch used to upload every batch's raw uint8
    fwd+rev rows (~2 * B * L bytes per batch).  With
    the query volume resident as [fwd | revcomp | slack] (the cns
    device-volume layout), a batch gather is B int32 ids up the wire and a
    vmapped contiguous dynamic_slice on device.  Reuses
    :func:`pipeline.cns.device_volume` (upload 2-bit packed, rc computed
    on device).
    """
    from .cns import device_volume

    sub = db if read_range is None else db.subset(range(*read_range))
    # int32 addressing guard (ADVICE r4): _gather_oriented_impl computes
    # rc starts as 2*n_bases - start - len in int32; past ~1 Gb of volume
    # bases the oriented layout silently overflows.  Mirror run_ref's
    # guard (ref.py) and fall back to the host gather path instead.
    if 2 * int(sub.total_bases) + 4 * int(sub.lengths.max(initial=0)) \
            >= (1 << 30):
        from ..utils.log import get_logger
        get_logger("pw").warning(
            "volume too large for int32 oriented device gather "
            "(%d bases); falling back to host query rows", sub.total_bases)
        return None
    return device_volume(sub)


def gather_oriented_rows_dev(qvol, ids: np.ndarray, n_valid: int, L: int):
    """[B, L] fwd + rev rows gathered ON DEVICE from an oriented volume.

    Bit-identical to ``pad_to_batch(oriented_batch(...))`` on the same
    reads (tests/test_pw_e2e.py differential): padding value 0, rows past
    ``n_valid`` zeroed, rc(read)[x] = vol_cat[2n - start - len + x].
    Returns (fwd_dev [B, L], rev_dev [B, L], lens_dev [B]).
    """
    import jax.numpy as jnp

    valid = np.zeros(len(ids), bool)
    valid[:n_valid] = True
    return _gather_oriented_jit(qvol.vol_cat, qvol.starts, qvol.lengths,
                                jnp.asarray(np.asarray(ids, np.int32)),
                                jnp.asarray(valid),
                                np.int32(qvol.n_bases), L=L)


def _gather_oriented_impl(vol_cat, starts, lengths, ids, valid, n_bases,
                          L: int):
    import jax
    import jax.numpy as jnp

    lens = jnp.where(valid, lengths[ids], 0).astype(jnp.int32)
    st_f = starts[ids].astype(jnp.int32)
    st_r = 2 * n_bases - st_f - lengths[ids].astype(jnp.int32)
    st_r = jnp.maximum(st_r, 0)          # pad rows: keep slices in bounds

    def row(o):
        return jax.lax.dynamic_slice(vol_cat, (o,), (L,))

    fwd = jax.vmap(row)(st_f)
    rev = jax.vmap(row)(st_r)
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    m = col < jnp.minimum(lens, L)[:, None]
    zero = jnp.zeros((), dtype=vol_cat.dtype)
    return jnp.where(m, fwd, zero), jnp.where(m, rev, zero), lens


_GATHER_JIT = None


def _gather_oriented_jit(*args, L: int):
    global _GATHER_JIT
    if _GATHER_JIT is None:
        import jax

        _GATHER_JIT = jax.jit(_gather_oriented_impl,
                              static_argnames=("L",))
    return _GATHER_JIT(*args, L=L)


def pad_to_batch(arrays: List[np.ndarray], batch: int) -> List[np.ndarray]:
    """Pad the leading dim of every array to `batch` (repeat-last padding)."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n == batch:
            out.append(a)
        else:
            pad = np.zeros((batch - n,) + a.shape[1:], dtype=a.dtype)
            out.append(np.concatenate([a, pad], axis=0))
    return out


def max_segs_for(L: int, S: int) -> int:
    """Scan length covering L query bases when each segment may re-align S//4."""
    return int(math.ceil(L / max(1, S - S // 4))) + 2
