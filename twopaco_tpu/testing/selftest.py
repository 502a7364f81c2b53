"""Randomized differential self-test (reference RunTests, test.cpp:163).

Sweeps k / rounds over random mutated genomes; the pipeline's junction
marks must equal the naive oracle's exactly, and every oracle junction
k-mer must resolve through Enumerator.get_id.
"""

from __future__ import annotations

import sys

import numpy as np

from twopaco_tpu import dna
from twopaco_tpu.io import junctions as junction_io
from twopaco_tpu.passes import INVALID_VERTEX, PipelineConfig, build_junctions
from twopaco_tpu.testing import oracle


def marks_mismatch(out_path: str, want: list[np.ndarray]) -> str | None:
    """None when the junction file at `out_path` marks exactly the
    oracle's positions `want` (one bool array per chromosome), else
    where it first differs."""
    chrs, pos, _ids = junction_io.read_junctions(out_path)
    if ((chrs < 0) | (chrs >= len(want))).any():
        return "a chromosome id out of range"
    for i, w in enumerate(want):
        p = pos[chrs == i]
        if ((p < 0) | (p >= len(w))).any():
            return f"chr {i}: a position out of range"
        got = np.zeros(len(w), bool)
        got[p] = True
        if not np.array_equal(got, w):
            return f"chr {i} pos {np.nonzero(got != w)[0][:5].tolist()}"
    return None


def run_tests(
    tests: int = 10,
    filter_bits: int = 20,
    length: int = 9000,
    chr_number: int = 6,
    k_values: tuple[int, ...] = (3, 5, 7, 9),
    hash_values: tuple[int, ...] = (1,),
    rounds_values: tuple[int, ...] = (1, 2, 3, 4),
    change_rate: float = 0.05,
    indel_rate: float = 0.1,
    tmpdir: str | None = None,
    seed: int | None = None,
    log=print,
) -> bool:
    """Defaults match the reference's sweep exactly (constructor.cpp:147:
    RunTests(10, 20, 9000, 6, k 3..9 odd, hf {1}, r {1..4}, thr {4})),
    run over BOTH engines; threads have no analogue here."""
    import os
    import tempfile

    rng = np.random.default_rng(seed)
    own_dir = None
    if tmpdir is None:
        own_dir = tempfile.TemporaryDirectory(prefix="twopaco_tpu_test_")
        tmpdir = own_dir.name
    out_path = os.path.join(tmpdir, "twopaco_tpu_selftest.bin")
    for t in range(tests):
        base = oracle.generate_sequence(rng, length)
        seqs = [base] + [
            oracle.mutate_sequence(rng, base, change_rate, indel_rate)
            for _ in range(chr_number - 1)
        ]
        sequences = [(i, dna.encode(s)) for i, s in enumerate(seqs)]
        for k in k_values:
            junc, want = oracle.find_junctions_naively(seqs, k)
            for rounds, hf, engine in [
                (r, h, e)
                for r in rounds_values
                for h in hash_values
                for e in ("sort", "bloom")
            ]:
                cfg = PipelineConfig(
                    k=k,
                    filter_bits=filter_bits,
                    hash_functions=hf,
                    rounds=rounds,
                    engine=engine,
                    positions_per_row=512,
                    rows_per_batch=8,
                )
                enum = build_junctions(
                    None, cfg, out_path=out_path, sequences=sequences
                )
                bad = marks_mismatch(out_path, want)
                if bad is not None:
                    log(
                        f"ERROR at {bad} "
                        f"(k={k} rounds={rounds} q={hf} engine={engine})"
                    )
                    log(f"Test # {t} FAILED")
                    return False
                junc = list(junc)
                missing = enum.get_ids(junc) == INVALID_VERTEX
                if junc and missing.any():
                    log(f"GetId failed for {junc[missing.argmax()]} (k={k})")
                    log(f"Test # {t} FAILED")
                    return False
        log(f"Test # {t} PASSED")
    if own_dir is not None:
        own_dir.cleanup()
    return True


if __name__ == "__main__":
    sys.exit(0 if run_tests() else 1)
