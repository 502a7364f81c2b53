"""CLI flag parsing + end-to-end twopaco|graphdump runs in-process."""

import io
import os
import sys

import numpy as np
import pytest

from tests.conftest import EXAMPLE_FA, GOLDEN_DIR
from twopaco_tpu.cli import graphdump as gd_cli
from twopaco_tpu.cli import twopaco as tp_cli
from twopaco_tpu.io import junctions


def test_twopaco_cli_end_to_end(tmp_path, capsys):
    out = str(tmp_path / "out.dbg")
    rc = tp_cli.main(
        [
            "-f", "20", "-k", "11", EXAMPLE_FA, "-o", out,
            "--tpu-positions", "256", "--tpu-rows", "4",
        ]
    )
    assert rc == 0
    assert "Distinct junctions = 7" in capsys.readouterr().out
    c, pos, _ids = junctions.read_junctions(out)
    gc, gpos, _g = junctions.read_junctions(
        os.path.join(GOLDEN_DIR, "example_k11.dbg")
    )
    np.testing.assert_array_equal(c, gc)
    np.testing.assert_array_equal(pos, gpos)


def test_twopaco_cli_flag_validation(capsys):
    assert tp_cli.main(["-k", "4", "-f", "20", "x.fa"]) == 1  # even k
    assert "odd" in capsys.readouterr().err
    assert tp_cli.main(["-k", "5", "x.fa"]) == 1  # no -f / --filtermemory
    assert "filtersize" in capsys.readouterr().err
    assert (
        tp_cli.main(["-k", "5", "-f", "20", "--filtermemory", "1", "x.fa"])
        == 1
    )  # XOR violated (constructor.cpp:142)
    assert tp_cli.main(["-k", "5", "-f", "20"]) == 1  # no inputs


def test_filtermemory_maps_to_bits():
    # 4 GB -> log2(3.2e10) = 34 (README.md:71-79 table)
    import math

    assert int(math.log2(4 * 8e9)) == 34


def test_graphdump_cli(tmp_path, capsys, monkeypatch):
    rc = gd_cli.main(
        ["-f", "seq", os.path.join(GOLDEN_DIR, "example_k11.dbg"), "-k", "11"]
    )
    assert rc == 0
    got = capsys.readouterr().out
    with open(os.path.join(GOLDEN_DIR, "example_k11.seq")) as fh:
        assert got == fh.read()


def test_graphdump_cli_requires_seqfile(capsys):
    rc = gd_cli.main(
        ["-f", "gfa1", os.path.join(GOLDEN_DIR, "example_k11.dbg"), "-k", "11"]
    )
    assert rc == 1
    assert "seqfilename" in capsys.readouterr().err
