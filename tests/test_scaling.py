"""Scaling harness smoke test on the virtual 8-device CPU mesh."""
import json


def test_scaling_report_shapes():
    from mecat_jax.utils.scaling import scaling_report

    lines = []
    rows = scaling_report(mesh_shapes=[(1, 1), (2, 1), (2, 2)], batch=8,
                          n_batches=2, n_reads=16, genome_n=12_000,
                          emit=lines.append)
    cfgs = [r for r in rows if "n_data" in r]
    assert [(r["n_data"], r["n_hash"]) for r in cfgs] == [(1, 1), (2, 1),
                                                          (2, 2)]
    for r in cfgs:
        assert r["step_seconds"] > 0
        assert r["scaling_efficiency"] is not None
        assert r["virtual_mesh"] is True  # CPU mesh flagged as such
    assert cfgs[0]["scaling_efficiency"] == 1.0
    # hash collective overhead row present (2,2) vs (4,1)? only when both
    # measured — here (4,1) absent, so no overhead row required
    for ln in lines:
        json.loads(ln)  # every emitted line is valid JSON
