"""The banded DP segment as a CUDA kernel, called through ``jax.ffi``.

``native/src/banded_dp.cu`` computes exactly what
``ops.align.banded_dp_segment`` + ``pick_end_local`` compute (moves, best
row, band cell, packed value), with one warp per pair and the band in
registers instead of one XLA launch per DP row.  This module owns what
surrounds it, all of which the CPU tests reach: which shapes it takes, the
result decoding, and the build of the shared library
(``nvcc`` for ``sm_90a`` at first use, into ``native/_build/``, rebuilt when
the source is newer).

On a GPU backend the kernel is the only DP path: a kernel that cannot be
built or loaded raises, it does not fall back to the plain scan.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

from .. import constants as C
from .align import IND_K, INF, VINF

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "native", "src", "banded_dp.cu")
_SO = os.path.join(_HERE, "native", "_build", "libbanded_dp.so")
_CUDA_HOME = "/usr/local/cuda"

#: band widths the kernel is instantiated for (32 lanes x W/32 cells)
KERNEL_WIDTHS = (32, 64, 128, 256)

_lock = threading.Lock()
_registered = False


def kernel_supported(S: int, W: int) -> bool:
    """Shapes the kernel takes: its band widths, 4-byte rows, and S < 1024
    (the best-cell key packs the row index into 10 bits)."""
    return W in KERNEL_WIDTHS and S % 4 == 0 and S < 1024


def nvcc_command(src: str, out: str, include_dir: str) -> list:
    """The build command: Hopper's own target (``sm_90a``), a shared lib."""
    return [os.path.join(_CUDA_HOME, "bin", "nvcc"),
            "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", include_dir, "-o", out, src]


def build(so_path: str = _SO, src: str = _SRC) -> str:
    """Compile the kernel library unless an up-to-date one exists."""
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src)):
        return so_path
    import jax.ffi

    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    # build to a temp name then rename: safe under concurrent processes
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so_path))
    os.close(fd)
    cmd = nvcc_command(src, tmp, jax.ffi.include_dir())
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        os.unlink(tmp)
        detail = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(f"banded DP kernel build failed: {detail[:2000]}"
                           ) from e
    os.replace(tmp, so_path)
    return so_path


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        import jax.ffi

        lib = ctypes.cdll.LoadLibrary(build())
        for name, sym in (("mecat_banded_dp_moves", lib.MecatBandedDpMoves),
                          ("mecat_banded_dp_best", lib.MecatBandedDpBest)):
            jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                        platform="CUDA")
        _registered = True


def decode_best(best, W: int):
    """[3, B] kernel record (row, band cell, packed value) ->
    (r, w, j, d, indels), the ``pick_end_local`` contract."""
    import jax.numpy as jnp

    r_best, w_best, v_best = best[0], best[1], best[2]
    d_best = jnp.where(v_best >= VINF, jnp.int32(INF), v_best // IND_K)
    ind_best = jnp.where(v_best >= VINF, 0, v_best % IND_K)
    return r_best, w_best, r_best - W // 2 + w_best, d_best, ind_best


def dp_segment_best_cuda(q_seg, tpad, tmax, seg_q, active=None, *, S: int,
                         W: int, with_moves: bool = True,
                         penalty: int = C.ALIGN_TRIM_PENALTY):
    """Run the kernel: (moves [S, B, W//16] or None, r, w, j, d, indels).

    q_seg uint8 [B, S]; tpad uint8 [B, S + W] (``ops.align.frame_target``);
    tmax, seg_q int32 [B]; active bool [B] or None (all active).  Inactive
    pairs get zero moves and the record r=0, j=0, d=INF, which callers
    never consume.
    """
    import jax
    import jax.numpy as jnp

    if not kernel_supported(S, W):
        raise ValueError(f"banded DP kernel has no instance for S={S}, W={W}")
    _register()
    B = q_seg.shape[0]
    act = (jnp.ones((B,), jnp.uint8) if active is None
           else active.astype(jnp.uint8))
    best_t = jax.ShapeDtypeStruct((3, B), jnp.int32)
    args = (q_seg.astype(jnp.uint8), tpad.astype(jnp.uint8),
            tmax.astype(jnp.int32), seg_q.astype(jnp.int32), act)
    if with_moves:
        moves, best = jax.ffi.ffi_call(
            "mecat_banded_dp_moves",
            (jax.ShapeDtypeStruct((S, B, W // 16), jnp.int32), best_t),
            vmap_method="sequential")(*args, penalty=np.int32(penalty))
    else:
        moves = None
        best = jax.ffi.ffi_call("mecat_banded_dp_best", best_t,
                                vmap_method="sequential")(
            *args, penalty=np.int32(penalty))
    return (moves,) + decode_best(best, W)
