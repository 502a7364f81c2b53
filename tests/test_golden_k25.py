"""k=25 reference-run parity (defaults-scale k, w=2 path)."""

import os

import numpy as np

from tests.conftest import EXAMPLE_FA, GOLDEN_DIR
from twopaco_tpu.io import fasta, junctions
from twopaco_tpu.passes import PipelineConfig, build_junctions


def test_example_k25_positions_and_group(tmp_path):
    out = str(tmp_path / "o.bin")
    cfg = PipelineConfig(
        k=25, filter_bits=20, positions_per_row=256, rows_per_batch=4
    )
    build_junctions([EXAMPLE_FA], cfg, out_path=out)
    c, pos, ids = junctions.read_junctions(out)
    want = np.loadtxt(
        os.path.join(GOLDEN_DIR, "example_k25.seq"), dtype=np.int64
    )
    np.testing.assert_array_equal(c, want[:, 0])
    np.testing.assert_array_equal(pos, want[:, 1])
    # group partition parity vs the reference run's ids
    def partition(cs, ps, idl):
        g = {}
        for cc, pp, ii in zip(cs, ps, idl):
            g.setdefault(int(ii), set()).add((int(cc), int(pp)))
        return sorted(sorted(v) for v in g.values())

    assert partition(c, pos, ids) == partition(
        want[:, 0], want[:, 1], want[:, 2]
    )
