"""ONT (config-4) accuracy floor — VERDICT r3 weak #8.

The nanopore preset path had no accuracy gate: the pacbio floors in
test_cns.py never exercise `-x 1`'s vote rules, whose e2e median was the
weakest tracked number.  This pins the controlled-pile proxy, which tracks
the config-4 e2e closely (measured 2026-08-20: piles rounds=1 median
98.474 vs e2e 98.435; rounds=2 99.356 vs e2e 99.354 — same seeds as here),
so a vote-rule or realignment regression on the ONT path trips in minutes
instead of a 40-minute chip e2e.

Reference role: mecat2cns -x 1 quality validation (SURVEY.md §4, §6 north
star: corrected median identity >= 99 on the ONT config).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from pile_harness import build_pile, run_pile  # noqa: E402

from mecat_jax import constants as C
from mecat_jax.pipeline.cns import CnsOptions
from mecat_jax.utils.accuracy import edit_stats, identity_pct
from mecat_jax.utils.sim import random_genome


def _ont_opts(rounds: int) -> CnsOptions:
    preset = C.CNS_TECH_PRESETS[C.TECH_NANOPORE]
    return CnsOptions(
        min_align_size=500, min_length=500, min_coverage=4,
        min_mapping_ratio=0.3, align_segment=128, align_band=64,
        extend_batch=32, min_identity=65.0, rounds=rounds,
        **{k: preset.get(k) for k in (
            "del_bias", "ins_bias", "pool_min_cov", "pool_min_cov_ins",
            "win_radius", "win_mass_frac", "win_peak_frac")})


def _pile_identities(rounds: int, n_piles: int = 4, length: int = 6000):
    rng = np.random.default_rng(7)
    idents = []
    for p in range(n_piles):
        truth = random_genome(length, seed=7000 + p)
        template, reads, seeds = build_pile(rng, truth, 10.0, 0.14,
                                            "nanopore")
        segs = run_pile(reads, seeds, _ont_opts(rounds))
        assert segs, f"pile {p}: no corrected output"
        seg = max(segs, key=len)
        st = edit_stats(seg, truth, band=512, mode=1)
        idents.append(identity_pct(st, len(seg)))
    return np.asarray(idents)


@pytest.mark.slow
def test_ont_cov10_accuracy_floor_rounds1():
    """Nanopore preset, 10x coverage, 14% error, one round: the weakest
    production configuration.  Floor pinned ~0.4 under the measured
    median (98.596, piles 98.30-98.84, at these test shapes 2026-08-20)."""
    idents = _pile_identities(rounds=1)
    med = float(np.median(idents))
    assert med >= 98.2, (med, idents.tolist())


@pytest.mark.slow
def test_ont_cov10_accuracy_floor_rounds2():
    """rounds=2 (the config-4 quality configuration) must clear the >= 99
    north-star bar on the pile proxy with margin to spare.  Floor pinned
    ~0.3 under the measured median (99.424, piles 99.33-99.52, at these
    test shapes 2026-08-20)."""
    idents = _pile_identities(rounds=2)
    med = float(np.median(idents))
    assert med >= 99.1, (med, idents.tolist())
