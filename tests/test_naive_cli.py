"""Naive constructor CLI: byte-identical to the pipeline output."""

import numpy as np

from tests.conftest import EXAMPLE_FA
from twopaco_tpu import dna
from twopaco_tpu.cli import naive
from twopaco_tpu.passes import PipelineConfig, build_junctions
from twopaco_tpu.testing import oracle


def test_naive_matches_pipeline_bytes(tmp_path):
    rng = np.random.default_rng(99)
    base = oracle.generate_sequence(rng, 600)
    seqs = [base, oracle.mutate_sequence(rng, base, 0.05, 0.1)]
    out_naive = str(tmp_path / "naive.bin")
    out_pipe = str(tmp_path / "pipe.bin")
    for k in (5, 9):
        naive.naive_junction_file(seqs, k, out_naive)
        cfg = PipelineConfig(
            k=k, filter_bits=20, positions_per_row=128, rows_per_batch=4
        )
        build_junctions(
            None,
            cfg,
            out_path=out_pipe,
            sequences=[(i, dna.encode(s)) for i, s in enumerate(seqs)],
        )
        a = open(out_naive, "rb").read()
        b = open(out_pipe, "rb").read()
        assert a == b, f"naive/pipeline mismatch at k={k}"


def test_naive_cli_example(tmp_path, capsys):
    out = str(tmp_path / "n.bin")
    rc = naive.main(
        ["-k", "11", EXAMPLE_FA, "-o", out]
    )
    assert rc == 0
    assert "Distinct junctions = 7" in capsys.readouterr().out
