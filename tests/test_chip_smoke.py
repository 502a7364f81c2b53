"""chip_smoke.py on the CPU: it must refuse to run, and the checks it
applies on the card must pass on good output and fail on corrupted
output."""

import os
import shutil
import subprocess
import sys

import numpy as np

from tests.conftest import EXAMPLE_FA
from twopaco_tpu import dna
from twopaco_tpu.cli import twopaco as tp_cli
from twopaco_tpu.io import junctions
from twopaco_tpu.passes import PipelineConfig, build_junctions
from twopaco_tpu.testing import golden, oracle
from twopaco_tpu.testing.selftest import marks_mismatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _cpu_env():
    return dict(os.environ, JAX_PLATFORMS="cpu")


def test_chip_smoke_refuses_cpu_backend():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_cpu_env(), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_bench_refuses_cpu_backend(tmp_path):
    # bench.py first asks a serve daemon on its socket to exit; point it
    # where no daemon can be
    env = dict(_cpu_env(), TWOPACO_SERVER_SOCKET=str(tmp_path / "none.sock"))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--quick"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "Mbases/s" not in r.stdout


def _corrupt(src, dst, record):
    """Copy a .dbg, moving one record's position (its first, low-order
    byte: records are u32 pos + i64 id) by one."""
    shutil.copy(src, dst)
    with open(dst, "r+b") as fh:
        fh.seek(12 * record)
        b = fh.read(1)
        fh.seek(12 * record)
        fh.write(bytes([b[0] ^ 1]))


def test_golden_checks_pass_and_catch_corruption(tmp_path):
    out = str(tmp_path / "ours.dbg")
    dt, log = chip_smoke.run_cli(["-k", "11", "-f", "20", EXAMPLE_FA, "-o", out])
    assert dt > 0 and "Distinct junctions = 7" in log
    assert golden.junction_parity(out, "example_k11") == []
    assert golden.graphdump_parity("example_k11", 11, EXAMPLE_FA) == []
    assert golden.first_difference(out, out) is None

    bad = str(tmp_path / "bad.dbg")
    _corrupt(out, bad, record=3)
    assert golden.junction_parity(bad, "example_k11")
    assert "differ at byte 36" in golden.first_difference(out, bad)


def test_normalise_gfa_blanks_only_paths():
    a = "S\t1\t*\tUR:Z:/x/example.fa\nS\t12\tACGT\n"
    b = "S\t1\t*\tUR:Z:other/example.fa\nS\t12\tACGT\n"
    assert golden.normalise_gfa(a) == golden.normalise_gfa(b)
    assert golden.normalise_gfa(a) != golden.normalise_gfa(
        b.replace("ACGT", "ACGA")
    )


def test_gfa_spell_check(tmp_path):
    text = golden.render(
        os.path.join(golden.GOLDEN_DIR, "example_k11.dbg"), "gfa1", 11,
        EXAMPLE_FA,
    )
    assert chip_smoke.gfa_spells(text, EXAMPLE_FA, 11) == []
    broken = text.replace("\t12\tTTTCTATC", "\t12\tTTTCTATG", 1)
    assert broken != text
    assert chip_smoke.gfa_spells(broken, EXAMPLE_FA, 11)


def test_oracle_check_passes_and_catches_corruption(tmp_path):
    rng = np.random.default_rng(5)
    base = oracle.generate_sequence(rng, 1500)
    seqs = [base, oracle.mutate_sequence(rng, base, 0.05, 0.1)]
    out = str(tmp_path / "o.dbg")
    build_junctions(
        None,
        PipelineConfig(k=9, positions_per_row=256, rows_per_batch=4),
        out_path=out,
        sequences=[(i, dna.encode(s)) for i, s in enumerate(seqs)],
    )
    _junc, want = oracle.find_junctions_naively(seqs, 9)
    assert marks_mismatch(out, want) is None
    chrs, _pos, _ids = junctions.read_junctions(out)
    assert len(chrs) > 4
    bad = str(tmp_path / "bad.dbg")
    _corrupt(out, bad, record=4)
    assert marks_mismatch(bad, want) is not None


def test_smoke_golden_table_covers_every_golden():
    names = {n for _fa, n, _k in chip_smoke.GOLDEN_RUNS}
    on_disk = {
        f[: -len(".seq")]
        for f in os.listdir(golden.GOLDEN_DIR)
        if f.endswith(".seq")
    }
    assert names == on_disk
    assert tp_cli.make_parser().parse_args(["--test"]).test
