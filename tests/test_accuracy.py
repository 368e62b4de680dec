"""utils/accuracy: exact banded edit stats (native + NumPy fallback)."""
import numpy as np
import pytest

from mecat_jax.utils.accuracy import (_edit_stats_numpy, edit_stats,
                                      identity_pct)


def brute(a, b, mode):
    la, lb = len(a), len(b)
    D = np.zeros((la + 1, lb + 1), np.int64)
    D[0, :] = 0 if mode == 1 else np.arange(lb + 1)
    D[:, 0] = np.arange(la + 1)
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            D[i, j] = min(D[i - 1, j - 1] + (a[i - 1] != b[j - 1]),
                          D[i - 1, j] + 1, D[i, j - 1] + 1)
    return int(D[la].min() if mode == 1 else D[la, lb])


@pytest.mark.parametrize("mode", [0, 1])
def test_edit_stats_exact_vs_brute(mode):
    rng = np.random.default_rng(5)
    for _ in range(40):
        la, lb = int(rng.integers(0, 50)), int(rng.integers(0, 50))
        a = rng.integers(0, 4, la).astype(np.uint8)
        b = rng.integers(0, 4, lb).astype(np.uint8)
        want = brute(a, b, mode)
        d, subs, ins, dels = edit_stats(a, b, band=4, mode=mode)
        assert d == want
        assert subs + ins + dels == d
        if mode == 0:
            assert ins - dels == la - lb
        # NumPy fallback must agree exactly (native-vs-fallback differential)
        assert _edit_stats_numpy(a, b, 4, mode) == (d, subs, ins, dels)


def test_edit_stats_decomposition():
    a = np.array([0, 1, 2, 3, 0, 0, 0, 1], np.uint8)
    b = np.array([0, 1, 2, 3, 0, 0, 1], np.uint8)
    assert edit_stats(a, b, mode=0) == (1, 0, 1, 0)     # one extra base in a
    assert edit_stats(b, a, mode=0) == (1, 0, 0, 1)     # ... = deletion in b
    b2 = np.concatenate([np.full(5, 2, np.uint8), a, np.full(4, 3, np.uint8)])
    # infix: free end gaps in b -> exact interior match scores 0
    assert edit_stats(a, b2, mode=1) == (0, 0, 0, 0)
    # global on the same pair pays for the flanks
    assert edit_stats(a, b2, mode=0)[0] == 9


def test_identity_pct():
    st = (0, 0, 0, 0)
    assert identity_pct(st, 100) == 100.0
    st = (2, 1, 1, 0)   # 1 sub + 1 ins on a 100-base read
    assert abs(identity_pct(st, 100) - 98.0) < 0.02


def test_band_widening_is_exact():
    """A long deletion forces the optimal path far off-diagonal; the
    dist < band acceptance rule must widen until exact."""
    rng = np.random.default_rng(7)
    core = rng.integers(0, 4, 300).astype(np.uint8)
    a = core
    b = np.concatenate([core[:150], rng.integers(0, 4, 90).astype(np.uint8),
                        core[150:]])
    d, subs, ins, dels = edit_stats(a, b, band=4, mode=0)
    assert (d, dels) == (brute(a, b, 0), 90) or d == brute(a, b, 0)
