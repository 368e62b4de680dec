"""The banded DP segment: a row-by-row NumPy model as the oracle, the plain
XLA path against it, the CUDA kernel's wrapper (framing, decoding, shapes,
build, choice of path) on the CPU, and the kernel itself on the card."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mecat_jax import constants as C
from mecat_jax.ops import align, dp_kernel
from mecat_jax.ops.align import (INF, IND_K, Q_SENTINEL, T_SENTINEL, VINF,
                                 banded_dp_segment, dp_segment_best,
                                 pick_end_local, traceback_counts)
from mecat_jax.utils.sim import mutate


def make_pairs(B, S, W, seed=121):
    """Noisy segment pairs with ragged query/target ends and a few
    partial-segment endpoints (seg_q < query length)."""
    rng = np.random.default_rng(seed)
    q = np.full((B, S), Q_SENTINEL, np.uint8)
    t = np.full((B, S + W // 2), T_SENTINEL, np.uint8)
    seg_q = np.zeros(B, np.int32)
    tmax = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(S // 4, S + 1))
        src = rng.integers(0, 4, n, dtype=np.uint8)
        err = (0.01, 0.04, 0.12)[b % 3]
        dst = mutate(src, rng, err * 0.2, err * 0.55, err * 0.25)
        dst = dst[:S + W // 2]
        q[b, :n] = src
        t[b, :len(dst)] = dst
        seg_q[b] = n if b % 5 else int(rng.integers(0, n + 1))
        tmax[b] = len(dst)
    return q, t, tmax, seg_q


def np_dp(q, t, tmax, seg_q, W, penalty=C.ALIGN_TRIM_PENALTY):
    """Row-by-row NumPy model of the banded DP + local-best endpoint.

    The horizontal closure is the serial recurrence
    cur[w] = min(cand[w], cur[w-1] + K1); the best cell is the first one in
    row-major order with the highest score r + j - 2*penalty*dist.
    Returns (moves [S, B, W//16], r, w, j, d, indels)."""
    q = q.astype(np.int64)
    B, S = q.shape
    half = W // 2
    K1 = IND_K + 1
    tpad = np.full((B, S + W), T_SENTINEL, np.int64)
    tpad[:, half:half + t.shape[1]] = t
    w_idx = np.arange(W)
    tmax = tmax.astype(np.int64)[:, None]
    j0 = w_idx[None, :] - half
    prev = np.where((j0 >= 0) & (j0 <= tmax), np.maximum(j0, 0) * K1, VINF)
    moves = np.zeros((S, B, W // 16), np.int64)
    best = np.full(B, -np.inf)
    best_r = np.zeros(B, np.int64)
    best_w = np.zeros(B, np.int64)
    best_v = np.zeros(B, np.int64)

    def consider(r, vals):
        j = r - half + w_idx[None, :]
        ok = ((j >= 0) & (j <= tmax) & (vals < VINF)
              & (r <= seg_q[:, None]))
        score = np.where(ok, r + j - 2 * penalty * (vals // IND_K),
                         -(1 << 26))
        arg = np.argmax(score, axis=1)
        top = score[np.arange(B), arg]
        upd = top > best
        best[upd] = top[upd]
        best_r[upd] = r
        best_w[upd] = arg[upd]
        best_v[upd] = vals[np.arange(B), arg][upd]

    consider(0, prev)
    for i in range(1, S + 1):
        sub = (q[:, i - 1:i] != tpad[:, i - 1:i - 1 + W]).astype(np.int64)
        diag = prev + sub * IND_K
        vert = np.concatenate([prev[:, 1:], np.full((B, 1), VINF)], 1) + K1
        j = i - half + w_idx[None, :]
        valid = (j >= 0) & (j <= tmax)
        cur = np.where(valid, np.minimum(diag, vert), VINF)
        for x in range(1, W):
            cur[:, x] = np.minimum(cur[:, x], cur[:, x - 1] + K1)
        cur = np.where(valid, np.minimum(cur, VINF), VINF)
        move = np.where(cur == diag, sub, np.where(cur == vert, 2, 3))
        shifts = 2 * (w_idx % 16)
        moves[i - 1] = (move << shifts).reshape(B, W // 16, 16).sum(-1)
        consider(i, cur)
        prev = cur
    moves = moves.astype(np.uint32).view(np.int32)
    d = np.where(best_v >= VINF, INF, best_v // IND_K)
    ind = np.where(best_v >= VINF, 0, best_v % IND_K)
    return moves, best_r, best_w, best_r - half + best_w, d, ind


def plain_outputs(q, t, tmax, seg_q, W):
    rows, moves = banded_dp_segment(jnp.asarray(q), jnp.asarray(t),
                                    jnp.asarray(tmax), W)
    best = pick_end_local(rows, jnp.asarray(seg_q), jnp.asarray(tmax), W)
    return (moves,) + tuple(best)


def assert_outputs_equal(got, want):
    names = ("moves", "r", "w", "j", "d", "indels")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("W", [128, 64])
def test_plain_dp_matches_numpy_model(W):
    S = 512
    q, t, tmax, seg_q = make_pairs(6, S, W)
    assert_outputs_equal(plain_outputs(q, t, tmax, seg_q, W),
                         np_dp(q, t, tmax, seg_q, W))


def test_dp_segment_best_plain_path_on_cpu():
    """kernel=None on the CPU backend is the plain path, framed or not."""
    S, W = 128, 64
    q, t, tmax, seg_q = make_pairs(5, S, W, seed=3)
    want = np_dp(q, t, tmax, seg_q, W)
    got = dp_segment_best(jnp.asarray(q), jnp.asarray(t), jnp.asarray(tmax),
                          jnp.asarray(seg_q), S, W)
    assert_outputs_equal(got, want)
    framed = align.frame_target(jnp.asarray(t), S, W)
    got = dp_segment_best(jnp.asarray(q), framed, jnp.asarray(tmax),
                          jnp.asarray(seg_q), S, W, want_moves=False)
    assert got[0] is None
    assert_outputs_equal(got[1:], want[1:])


def test_move_layout_round_trips_through_read_move():
    """Packed [S, B, W//16] words give back every 2-bit code by (row, band
    cell, pair), and traceback_counts over the plain moves agrees with the
    closed form matches = (r + j + indels)/2 - d of the best record."""
    S, W, B = 128, 64, 7
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (S, B, W))
    packed = (codes << (2 * (np.arange(W) % 16))).reshape(
        S, B, W // 16, 16).sum(-1).astype(np.uint32).view(np.int32)
    for _ in range(20):
        i = rng.integers(1, S + 1, B)
        w = rng.integers(0, W, B)
        got = align._read_move(jnp.asarray(packed), jnp.asarray(i),
                               jnp.asarray(w))
        np.testing.assert_array_equal(np.asarray(got),
                                      codes[i - 1, np.arange(B), w])

    q, t, tmax, seg_q = make_pairs(B, S, W, seed=9)
    moves, r, w, j, d, ind = plain_outputs(q, t, tmax, seg_q, W)
    m, alen, lead = traceback_counts(moves, r, w, W)
    ok = np.asarray(d) < INF
    closed = (np.asarray(r) + np.asarray(j) + np.asarray(ind)) // 2 \
        - np.asarray(d)
    np.testing.assert_array_equal(np.asarray(m)[ok], closed[ok])


def test_frame_target_and_decode_best():
    S, W = 16, 32
    t = np.arange(3 * (S + W // 2), dtype=np.uint8).reshape(3, -1)
    framed = align.frame_target(jnp.asarray(t), S, W)
    assert framed.shape == (3, S + W)
    framed_np = np.asarray(framed)
    np.testing.assert_array_equal(framed_np[:, W // 2:W // 2 + t.shape[1]], t)
    assert (framed_np[:, :W // 2] == T_SENTINEL).all()
    assert (framed_np[:, W // 2 + t.shape[1]:] == T_SENTINEL).all()
    assert align.frame_target(framed, S, W) is framed

    best = jnp.asarray(np.array([[5, 0], [40, W // 2],
                                 [3 * IND_K + 7, VINF]], np.int32))
    r, w, j, d, ind = (np.asarray(a) for a in dp_kernel.decode_best(best, W))
    np.testing.assert_array_equal(r, [5, 0])
    np.testing.assert_array_equal(j, [5 - W // 2 + 40, 0])
    np.testing.assert_array_equal(d, [3, INF])
    np.testing.assert_array_equal(ind, [7, 0])


def test_kernel_shapes_and_build_command():
    assert dp_kernel.kernel_supported(512, 128)
    assert dp_kernel.kernel_supported(512, 64)
    assert not dp_kernel.kernel_supported(512, 96)     # no instance
    assert not dp_kernel.kernel_supported(1024, 128)   # row key has 10 bits
    assert not dp_kernel.kernel_supported(510, 128)    # 4-byte rows
    with pytest.raises(ValueError, match="no instance"):
        dp_kernel.dp_segment_best_cuda(None, None, None, None, S=512, W=96)
    cmd = dp_kernel.nvcc_command("k.cu", "k.so", "inc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == "k.cu" and "-shared" in cmd


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    """No toolchain means an error, never a silent fallback."""
    src = tmp_path / "k.cu"
    src.write_text("// empty\n")
    monkeypatch.setattr(dp_kernel, "_CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="build failed"):
        dp_kernel.build(str(tmp_path / "out" / "k.so"), str(src))
    assert not any((tmp_path / "out").iterdir())     # temp file removed


def test_kernel_choice_follows_backend_and_dp_path(monkeypatch):
    from mecat_jax.utils import device

    monkeypatch.setattr(device, "on_accelerator", lambda: True)
    assert align.use_dp_kernel()
    with align.dp_path(kernel=False):
        assert not align.use_dp_kernel()
    assert align.use_dp_kernel()
    monkeypatch.setattr(device, "on_accelerator", lambda: False)
    assert not align.use_dp_kernel()
    with align.dp_path(kernel=True):
        assert align.use_dp_kernel()
    assert not align.use_dp_kernel()


def test_dp_path_retraces_jitted_callers(monkeypatch):
    """dp_path clears the jit caches, so a function traced before picks up
    the path chosen inside (the end-to-end A/B relies on it)."""
    from mecat_jax.utils import device

    monkeypatch.setattr(device, "on_accelerator", lambda: False)
    seen = []

    @jax.jit
    def f(x):
        seen.append(align.use_dp_kernel())
        return x + 1

    f(jnp.int32(1))
    with align.dp_path(kernel=True):
        f(jnp.int32(1))
    f(jnp.int32(1))
    assert seen == [False, True, False]


@pytest.mark.gpu
@pytest.mark.parametrize("W", [128, 64])
@pytest.mark.parametrize("with_moves", [True, False])
def test_kernel_matches_reference_on_card(gpu, W, with_moves):
    """The CUDA kernel equals the NumPy model and the plain XLA path on every
    output at the production shapes (S=512, B=2048)."""
    S, B = 512, 2048
    q, t, tmax, seg_q = make_pairs(B, S, W, seed=2048 + W)
    want = np_dp(q, t, tmax, seg_q, W)
    args = tuple(jnp.asarray(a) for a in (q, t, tmax, seg_q))
    got = dp_segment_best(*args, S, W, want_moves=with_moves, kernel=True)
    plain = dp_segment_best(*args, S, W, want_moves=with_moves, kernel=False)
    if with_moves:
        assert_outputs_equal(got, want)
        assert_outputs_equal(got, plain)
    else:
        assert got[0] is None
        assert_outputs_equal(got[1:], want[1:])
        assert_outputs_equal(got[1:], plain[1:])


@pytest.mark.gpu
def test_kernel_skips_inactive_pairs_on_card(gpu):
    S, W, B = 512, 128, 256
    q, t, tmax, seg_q = make_pairs(B, S, W, seed=77)
    active = np.arange(B) % 3 != 0
    args = tuple(jnp.asarray(a) for a in (q, t, tmax, seg_q))
    full = dp_segment_best(*args, S, W, kernel=True)
    masked = dp_segment_best(*args, S, W, active=jnp.asarray(active),
                             kernel=True)
    for a, b in zip(full[1:], masked[1:]):
        np.testing.assert_array_equal(np.asarray(a)[active],
                                      np.asarray(b)[active])
    np.testing.assert_array_equal(np.asarray(full[0])[:, active],
                                  np.asarray(masked[0])[:, active])
    r, w, j, d, ind = (np.asarray(a)[~active] for a in masked[1:])
    assert (d == INF).all() and (r == 0).all() and (j == 0).all()
    assert (np.asarray(masked[0])[:, ~active] == 0).all()
