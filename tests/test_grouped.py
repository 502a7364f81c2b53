"""Grouped-resident engine (records exceed the HBM budget: one
partition scan per GROUP of rounds) must be byte-identical to the
resident engine on the same input."""

import numpy as np

from twopaco_tpu.passes import sortpipe
from twopaco_tpu.passes.pipeline import PipelineConfig


def _run(tmp_path, name, seqs, **cfg_kw):
    out = str(tmp_path / name)
    cfg = PipelineConfig(k=9, filter_bits=20, rounds=6, **cfg_kw)
    enum = sortpipe.build_junctions_sorted(
        None, cfg, out_path=out, sequences=[(i, s) for i, s in enumerate(seqs)]
    )
    return out, enum


def test_grouped_matches_resident(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, size=6000).astype(np.uint8)
    seqs = []
    for i in range(4):
        s = base.copy()
        if i:
            flip = rng.random(len(s)) < 0.02
            s[flip] = rng.integers(0, 4, size=int(flip.sum()))
        seqs.append(s)

    ref_out, ref_enum = _run(tmp_path, "resident.dbg", seqs)

    # shrink the resident budget so the same run goes grouped
    monkeypatch.setenv("TWOPACO_RESIDENT_BYTES", "1")
    got_out, got_enum = _run(tmp_path, "grouped.dbg", seqs)

    assert got_enum.vertices_count == ref_enum.vertices_count
    with open(ref_out, "rb") as a, open(got_out, "rb") as b:
        assert a.read() == b.read()


def test_grouped_checkpoint_resume(tmp_path, monkeypatch):
    rng = np.random.default_rng(12)
    seqs = [rng.integers(0, 4, size=5000).astype(np.uint8) for _ in range(3)]

    monkeypatch.setenv("TWOPACO_RESIDENT_BYTES", "1")
    ck = str(tmp_path / "ck")
    cfg = PipelineConfig(k=9, filter_bits=20, rounds=5)
    sl = [(i, s) for i, s in enumerate(seqs)]
    out1 = str(tmp_path / "a.dbg")
    sortpipe.build_junctions_sorted(
        None, cfg, out_path=out1, sequences=sl, checkpoint_dir=ck
    )
    out2 = str(tmp_path / "b.dbg")
    logs = []
    sortpipe.build_junctions_sorted(
        None, cfg, out_path=out2, sequences=sl, checkpoint_dir=ck,
        log=logs.append,
    )
    assert any("restored from checkpoint" in s for s in logs)
    with open(out1, "rb") as a, open(out2, "rb") as b:
        assert a.read() == b.read()


def test_grouped_wide_matches_narrow(tmp_path, monkeypatch):
    """Grouped engine with forced wide positions must match the
    default narrow resident run byte-for-byte."""
    rng = np.random.default_rng(13)
    base = rng.integers(0, 4, size=4000).astype(np.uint8)
    seqs = []
    for i in range(3):
        s = base.copy()
        if i:
            flip = rng.random(len(s)) < 0.02
            s[flip] = rng.integers(0, 4, size=int(flip.sum()))
        seqs.append(s)

    ref_out, ref_enum = _run(tmp_path, "narrow.dbg", seqs)

    monkeypatch.setenv("TWOPACO_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TWOPACO_POS64", "1")
    got_out, got_enum = _run(tmp_path, "wide_grouped.dbg", seqs)

    assert got_enum.vertices_count == ref_enum.vertices_count
    with open(ref_out, "rb") as a, open(got_out, "rb") as b:
        assert a.read() == b.read()
