"""graphdump formats: byte-parity vs reference outputs on the committed
example.dbg (generated by the reference graphdump binary from the same
input file, so every format must match exactly)."""

import io
import os

import pytest

from tests.conftest import EXAMPLE_FA as FA
from tests.conftest import GOLDEN_DIR
from twopaco_tpu.formats import graphdump as gd
from twopaco_tpu.testing.golden import normalise_gfa

DBG = os.path.join(GOLDEN_DIR, "example_k11.dbg")


def golden(name: str) -> str:
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
        return fh.read()


def render(fn, *args, **kw) -> str:
    buf = io.StringIO()
    fn(*args, out=buf, **kw)
    return buf.getvalue()


def test_seq_matches_reference():
    assert render(gd.generate_seq, DBG) == golden("example_k11.seq")


def test_group_matches_reference():
    assert render(gd.generate_group, DBG) == golden("example_k11.group")


def test_dot_matches_reference():
    assert render(gd.generate_dot, DBG) == golden("example_k11.dot")


def test_gfa1_matches_reference():
    got = render(gd.generate_gfa, DBG, [FA], 11, version=1)
    # UR:Z: names the FASTA path, which differs from the reference run's
    assert f"UR:Z:{FA}\n" in got
    assert normalise_gfa(got) == normalise_gfa(golden("example_k11.gfa1"))


def test_gfa2_matches_reference():
    got = render(gd.generate_gfa, DBG, [FA], 11, version=2)
    assert normalise_gfa(got) == normalise_gfa(golden("example_k11.gfa2"))


def test_fasta_matches_reference():
    got = render(gd.generate_fasta, DBG, [FA], 11)
    assert got == golden("example_k11.fasta")


def test_gfa_spells_back_genomes():
    """Glue check (reference glueGfa1.py idea): walking each GFA1 path and
    overlapping segments by k-1... here: concatenating path segments with
    k-char overlaps reproduces each input chromosome."""
    from twopaco_tpu.io import fasta as fasta_io

    k = 11
    text = render(gd.generate_gfa, DBG, [FA], k, version=1)
    seg_body = {}
    paths = {}
    for line in text.splitlines():
        f = line.split("\t")
        if f[0] == "S" and len(f) == 3:
            seg_body[int(f[1])] = f[2]
        elif f[0] == "P":
            paths[f[1]] = f[2].split(",")
    seqs = list(fasta_io.read_fasta(FA))
    assert len(paths) == len(seqs)
    for (hdr, codes) in seqs:
        want = "".join("ACGTN"[c] for c in codes)
        walk = None
        for step in paths[hdr]:
            sid, sign = int(step[:-1]), step[-1]
            body = seg_body[sid]
            if sign == "-":
                body = gd._revcomp_text(body)
            if walk is None:
                walk = body
            else:
                assert walk[-k:] == body[:k]
                walk += body[k:]
        assert walk == want
