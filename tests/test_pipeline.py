"""End-to-end pipeline: differential vs naive oracle + reference goldens."""

import os

import numpy as np
import pytest

from tests.conftest import EXAMPLE_FA, GOLDEN_DIR
from twopaco_tpu import dna
from twopaco_tpu.io import fasta, junctions
from twopaco_tpu.passes import PipelineConfig, build_junctions, INVALID_VERTEX
from twopaco_tpu.testing import oracle


def run_pipeline(seqs, k, out, **kw):
    cfg = PipelineConfig(
        k=k,
        filter_bits=kw.pop("filter_bits", 20),
        rounds=kw.pop("rounds", 1),
        positions_per_row=kw.pop("positions_per_row", 256),
        rows_per_batch=kw.pop("rows_per_batch", 4),
        **kw,
    )
    sequences = [(i, dna.encode(s)) for i, s in enumerate(seqs)]
    return build_junctions(None, cfg, out_path=out, sequences=sequences)


def marks_from_file(path, seqs, k):
    c, pos, _ids = junctions.read_junctions(path)
    out = [np.zeros(len(s), bool) for s in seqs]
    for ci, pi in zip(c, pos):
        out[ci][pi] = True
    return out


@pytest.mark.parametrize("k", [3, 5, 7, 9])
@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("engine", ["sort", "bloom"])
def test_differential_vs_oracle(tmp_path, k, rounds, engine):
    rng = np.random.default_rng(1234 + k + rounds)
    base = oracle.generate_sequence(rng, 900)
    seqs = [base] + [
        oracle.mutate_sequence(rng, base, 0.05, 0.1) for _ in range(3)
    ]
    out = str(tmp_path / "out.bin")
    enum = run_pipeline(seqs, k, out, rounds=rounds, engine=engine)
    junc, want = oracle.find_junctions_naively(seqs, k)
    got = marks_from_file(out, seqs, k)
    for i in range(len(seqs)):
        np.testing.assert_array_equal(
            got[i], want[i], err_msg=f"seq {i} k={k} rounds={rounds}"
        )
    # every naive junction k-mer must resolve via GetId (test.cpp:234-242)
    for v in junc:
        assert enum.get_id(v) != INVALID_VERTEX


def test_bloom_mask_spill_byte_identical(tmp_path, monkeypatch):
    """TWOPACO_MASK_SPILL_BYTES=0 forces every round's candidate masks
    to disk (the reference's candidate_<round>.tmp analogue,
    vertexenumerator.h:485-490); pass 4 must read them back mmap'd and
    produce byte-identical output."""
    rng = np.random.default_rng(77)
    base = oracle.generate_sequence(rng, 900)
    seqs = [base] + [
        oracle.mutate_sequence(rng, base, 0.05, 0.1) for _ in range(2)
    ]
    ref = str(tmp_path / "resident.bin")
    run_pipeline(seqs, 9, ref, rounds=3, engine="bloom")
    monkeypatch.setenv("TWOPACO_MASK_SPILL_BYTES", "0")
    spill = str(tmp_path / "spilled.bin")
    run_pipeline(seqs, 9, spill, rounds=3, engine="bloom")
    with open(ref, "rb") as f1, open(spill, "rb") as f2:
        assert f1.read() == f2.read()
    # spill files are cleaned up
    import glob

    assert not glob.glob("/tmp/twopaco_masks_*")


def test_example_positions_match_reference_golden(tmp_path):
    """Junction positions on example.fa k=11 equal the committed
    reference output (ids/signs legitimately differ: SURVEY.md §5)."""
    seqs = list(fasta.read_sequences_text([EXAMPLE_FA]))
    out = str(tmp_path / "out.bin")
    enum = run_pipeline(seqs, 11, out)
    c, pos, ids = junctions.read_junctions(out)
    gc, gpos, gids = junctions.read_junctions(
        os.path.join(GOLDEN_DIR, "example_k11.dbg")
    )
    np.testing.assert_array_equal(c, gc)
    np.testing.assert_array_equal(pos, gpos)
    assert enum.vertices_count == 7  # BASELINE.md golden run
    assert enum.stats.occurrences == 16
    # group partition must match: same-id classes of (chr,pos) tuples
    def partition(cs, ps, idl):
        groups = {}
        for cc, pp, ii in zip(cs, ps, idl):
            groups.setdefault(ii, set()).add((int(cc), int(pp)))
        return sorted(
            (sorted(v) for v in groups.values()), key=lambda g: g[0]
        )

    assert partition(c, pos, ids) == partition(gc, gpos, gids)


def test_signs_consistent_between_strands(tmp_path):
    """A junction and its RC occurrence get opposite signs."""
    s = "ACGTACGTTTGCATGCAAACGTACGT"
    seqs = [s, dna.revcomp_str(s)]
    out = str(tmp_path / "out.bin")
    run_pipeline(seqs, 5, out)
    c, pos, ids = junctions.read_junctions(out)
    # forward strand junction set == mirrored negated reverse strand set
    L = len(s)
    fwd = {(p, i) for cc, p, i in zip(c, pos, ids) if cc == 0}
    rev = {(L - 5 - p, -i) for cc, p, i in zip(c, pos, ids) if cc == 1}
    fwd_real = {(p, i) for p, i in fwd if abs(i) <= 7}  # drop stub ids
    rev_real = {(p, i) for p, i in rev if abs(i) <= 7}
    assert fwd_real == rev_real


def test_determinism(tmp_path):
    rng = np.random.default_rng(7)
    seqs = [oracle.generate_sequence(rng, 500) for _ in range(2)]
    outs = []
    for i in range(2):
        out = str(tmp_path / f"o{i}.bin")
        run_pipeline(seqs, 7, out)
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


def test_abundance_filter(tmp_path):
    """-a drops junctions occurring more than `abundance` times
    (TrueBifurcations, vertexenumerator.h:1240)."""
    rng = np.random.default_rng(3)
    base = oracle.generate_sequence(rng, 400)
    seqs = [base] * 5  # every junction occurs >= 5 times
    out = str(tmp_path / "out.bin")
    enum = run_pipeline(seqs, 7, out, abundance=2)
    assert enum.vertices_count == 0  # all junctions filtered
    c, pos, ids = junctions.read_junctions(out)
    # only stubs remain (2 per sequence)
    assert len(ids) == 10
    assert (ids >= 42).all()
