"""Run-time device decisions: the accelerator gate, the memory-sized caps
and the compile-cache directory."""
import os

import numpy as np
import pytest

import jax

import mecat_jax
from mecat_jax import constants as C
from mecat_jax.utils import device


@pytest.mark.parametrize("backend,expected", [("gpu", True), ("cpu", False)])
def test_accelerator_gate_picks_paths(monkeypatch, backend, expected):
    """One helper decides every device path: device index build, device
    gather, fused -j 1, device cns — taken on a GPU backend, host paths on
    the CPU backend, and the env overrides still win."""
    from mecat_jax.index import kmer_index
    from mecat_jax.pipeline import cns, pw

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    for k in ("MECAT_PW_DEV_GATHER", "MECAT_HOST_PW", "MECAT_FORCE_FUSED",
              "MECAT_HOST_CNS", "MECAT_HOST_INDEX_BUILD"):
        monkeypatch.delenv(k, raising=False)
    assert device.on_accelerator() is expected
    assert pw._use_dev_gather() is expected
    assert pw._use_fused(pw.PwOptions(task=1)) is expected
    assert not pw._use_fused(pw.PwOptions(task=0))
    assert (cns._pick_correct_batch() is cns.correct_batch_device) is expected

    calls = []
    monkeypatch.setattr(kmer_index, "_build_index_device",
                        lambda *a, **k: calls.append(a) or "device")
    codes = np.zeros(64, np.uint8)
    out = kmer_index.build_index(codes, np.array([0]), np.array([64]), k=5)
    assert (out == "device") is expected

    monkeypatch.setenv("MECAT_PW_DEV_GATHER", "1")
    monkeypatch.setenv("MECAT_FORCE_FUSED", "1")
    assert pw._use_dev_gather() and pw._use_fused(pw.PwOptions(task=1))
    monkeypatch.setenv("MECAT_HOST_CNS", "1")
    assert cns._pick_correct_batch() is cns.correct_batch


class _FakeDevice:
    device_kind = "fake"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_memory_caps_keep_cpu_values():
    """On the CPU backend every cap is today's value, so the tests run the
    same volume splits and table slices as before."""
    from mecat_jax.pipeline import pw

    assert device.memory_scaled(1 << 29) == 1 << 29
    assert pw.default_volume_bases() == C.DEFAULT_VOLUME_BASES
    assert pw._qvol_cache_cap() == 6


def test_memory_caps_scale_with_device_memory(monkeypatch):
    from mecat_jax.pipeline import pw

    monkeypatch.setattr(device, "on_accelerator", lambda: True)
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice({"bytes_limit": 60 << 30})])
    assert device.memory_scaled(1 << 29) == (1 << 29) * 60 // 16
    assert pw.default_volume_bases() == C.DEFAULT_VOLUME_BASES * 60 // 16
    assert pw._qvol_cache_cap() == 6 * 60 // 16
    monkeypatch.setenv("MECAT_QVOL_CACHE", "2")
    assert pw._qvol_cache_cap() == 2


def test_memory_caps_raise_without_bytes_limit(monkeypatch):
    monkeypatch.setattr(device, "on_accelerator", lambda: True)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice({})])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device.memory_scaled(1 << 29)


def test_cns_table_cap_from_device(monkeypatch):
    """The cns table cap follows the device unless the env var is set."""
    from mecat_jax.io.packed_db import PackedDB
    from mecat_jax.io.fasta import FastaRecord
    from mecat_jax.pipeline import cns

    db = PackedDB.from_records([FastaRecord(f"r{i}", np.zeros(3000, np.uint8))
                                for i in range(40)])
    templates = list(range(40))
    seen = []
    monkeypatch.setattr(cns, "memory_scaled",
                        lambda v: seen.append(v) or (1 << 20))
    monkeypatch.delenv("MECAT_CNS_TABLE_BYTES", raising=False)
    small = cns.plan_table_slices(db, templates)
    assert seen == [1 << 29] and len(small) > 1
    monkeypatch.setenv("MECAT_CNS_TABLE_BYTES", str(1 << 30))
    assert cns.plan_table_slices(db, templates) == [templates]


def test_compile_cache_dir_rule(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert mecat_jax.compile_cache_dir() == "/some/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert mecat_jax.compile_cache_dir() == mecat_jax.DEFAULT_COMPILE_CACHE
    assert mecat_jax.DEFAULT_COMPILE_CACHE.endswith(".jax_cache")
    assert os.path.dirname(mecat_jax.DEFAULT_COMPILE_CACHE) == \
        os.path.dirname(os.path.dirname(os.path.abspath(mecat_jax.__file__)))
