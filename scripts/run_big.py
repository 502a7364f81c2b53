"""≥5 Gbase single-chip run (wide-position + scan-stream demo).

Proves the sort engine's >4.2 Gbase path end-to-end on real hardware:
5 Gbases forces wide (u32-pair) flat positions and the non-resident
scan-stream mode with checkpointed rounds. Writes the junction binary,
then validates well-formedness (parseable records, per-chromosome
nondecreasing positions, stub/junction id ranges) and records
RUN_BIG.json at the repo root.

Run SOLO on the GPU: python scripts/run_big.py [total_gbases]
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMP = tempfile.gettempdir()  # input, output and checkpoints of the run
_ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_big_fasta(path: str, n_seqs: int, length: int, seed: int = 5) -> None:
    """Chunked generation: one warm 64M scratch per stream instead of
    multi-GB temporaries (first-touch page faults cost ~100us on this
    VM — a fresh 4 GB array would burn minutes before any work)."""
    marker = f"{path}.ok-{n_seqs}x{length}"
    if os.path.exists(marker) and os.path.exists(path):
        return
    chunk = 64 << 20
    base_rng = np.random.default_rng(seed)
    chunk_seeds = base_rng.integers(0, 1 << 62, size=-(-length // chunk))
    with open(path, "wb") as f:
        for i in range(n_seqs):
            f.write(f">big{i}\n".encode())
            mut_rng = np.random.default_rng(seed + 1000 + i)
            for c, cs in enumerate(chunk_seeds):
                n = min(chunk, length - c * chunk)
                crng = np.random.default_rng(cs)
                s = _ALPHA[crng.integers(0, 4, size=n)]
                if i:
                    flip = mut_rng.random(n) < 0.01
                    s[flip] = _ALPHA[
                        mut_rng.integers(0, 4, size=int(flip.sum()))
                    ]
                f.write(s.tobytes())
            f.write(b"\n")
    open(marker, "w").write("ok\n")


def validate(out: str, n_seqs: int, length: int, n_junc: int) -> dict:
    from twopaco_tpu.io import junctions
    from twopaco_tpu.passes.pipeline import STUB_ID_OFFSET

    c, pos, ids = junctions.read_junctions(out)
    ok_chr = bool((np.diff(c) >= 0).all()) and int(c.max()) == n_seqs - 1
    # positions nondecreasing within each chromosome
    brk = np.flatnonzero(np.diff(c) != 0)
    d = np.diff(pos.astype(np.int64))
    d[brk] = 0
    ok_pos = bool((d >= 0).all()) and int(pos.max()) < length
    aid = np.abs(ids)
    ok_ids = bool(
        (((aid >= 1) & (aid <= n_junc))
         | (aid >= n_junc + STUB_ID_OFFSET)).all()
    )
    return dict(
        records=int(len(ids)),
        chr_ok=ok_chr,
        pos_ok=ok_pos,
        ids_ok=ok_ids,
    )


def attach_reference(res: dict, out: str, total: int) -> None:
    """Attach the reference binary's wall/parity to res, when its run
    on the same input exists ($TMPDIR/twopaco_big_ref.dbg + log line
    'exit=0 wall=<s>s' from the companion run)."""
    ref_dbg = os.path.join(TMP, "twopaco_big_ref.dbg")
    ref_log = os.path.join(TMP, "big_ref.log")
    if not (
        total == 5_000_000_000  # the measured reference ran on 10x500M
        and os.path.exists(ref_dbg)
        and os.path.exists(ref_log)
    ):
        return
    import re

    m = re.search(r"exit=0 wall=(\d+)s", open(ref_log).read())
    if not m:
        return
    # an earlier SOLO measurement of the same reference binary, config
    # and input scale on a 4-core host was 3615 s; a run here can be
    # slower when other work contends for cores — compare against the
    # FASTER (conservative, reference-favoring) of the two
    this_run_s = int(m.group(1))
    ref_s = min(this_run_s, 3615)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import check_parity as cp
    from twopaco_tpu.io import junctions

    res["reference"] = dict(
        seconds=ref_s,
        this_host_seconds=this_run_s,
        solo_measured_seconds=3615,
        mbases_per_sec=round(total / ref_s / 1e6, 3),
        config="-k 25 -f 36 -r 1 -t 4",
    )
    res["parity_vs_reference"] = bool(
        cp.partitions_equal(
            junctions.read_junctions(out),
            junctions.read_junctions(ref_dbg),
        )
    )
    # pin the parity evidence to the exact bytes it was checked on, so
    # a future carry-forward can prove it applies (counts alone don't)
    res["dbg_sha256"] = _sha256(out)


def _sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 22), b""):
            h.update(blk)
    return h.hexdigest()


def main():
    args = [a for a in sys.argv[1:] if a != "--attach-ref"]
    gb = float(args[0]) if args else 5.0
    n_seqs, length = 10, int(gb * 1e9 / 10)
    fa = os.path.join(TMP, "twopaco_big.fa")
    out = os.path.join(TMP, "twopaco_big.dbg")
    res_path = os.path.join(REPO, "RUN_BIG.json")
    if "--attach-ref" in sys.argv:
        # post-hoc: the reference run finished after ours; merge its
        # wall + parity into the recorded result without redoing the run
        res = json.load(open(res_path))
        attach_reference(res, out, res["total_bases"])
        print(json.dumps(res), flush=True)
        json.dump(res, open(res_path, "w"), indent=2)
        return
    print(f"generating {n_seqs} x {length/1e6:.0f} Mb ...", flush=True)
    write_big_fasta(fa, n_seqs, length)

    from twopaco_tpu.passes import PipelineConfig, build_junctions

    t0 = time.monotonic()
    # bigger sort buffers halve the round count (each round re-hashes
    # the whole input, reference-style); fall back if the larger sort
    # program does not fit the device
    for chunk_pow in (26, 25, 24, 22):
        cfg = PipelineConfig(
            k=25,
            filter_bits=30,
            positions_per_row=16384,
            rows_per_batch=128,
            sort_chunk=1 << chunk_pow,
        )
        try:
            enum = build_junctions(
                [fa], cfg, out_path=out,
                log=lambda s: print(s, flush=True),
                checkpoint_dir=os.path.join(TMP, "twopaco_big_ckpt"),
            )
            break
        except Exception as e:
            print(f"sort_chunk 2^{chunk_pow} failed: {e}", flush=True)
            if chunk_pow == 22:
                raise
    dt = time.monotonic() - t0
    total = n_seqs * length
    res = dict(
        total_bases=total,
        seconds=round(dt, 2),
        mbases_per_sec=round(total / dt / 1e6, 3),
        distinct_junctions=enum.vertices_count,
        occurrences=enum.stats.occurrences,
        rounds=len(enum.stats.rounds),
        wide_positions=total >= (1 << 32),
        validate=validate(out, n_seqs, length, enum.vertices_count),
        timings={k: round(v, 2) for k, v in enum.stats.timings.items()},
    )
    attach_reference(res, out, total)
    res.setdefault("dbg_sha256", _sha256(out))
    if "reference" not in res and os.path.exists(res_path):
        # identical input (same generator/seed) + byte-deterministic
        # engine => this run's junction set equals the one the earlier
        # recorded run parity-checked against the reference binary —
        # but only provably so when the produced .dbg is BYTE-IDENTICAL
        # to the one that was actually checked (counts alone don't
        # establish set equality); carry the evidence forward instead
        # of redoing the ~1h reference run only under that hash guard
        try:
            prev = json.load(open(res_path))
            if (
                prev.get("total_bases") == total
                and prev.get("parity_vs_reference")
                and prev.get("dbg_sha256")
                and prev.get("dbg_sha256") == res["dbg_sha256"]
            ):
                res["reference"] = prev["reference"]
                res["parity_vs_reference"] = True
                res["parity_note"] = (
                    "carried from the previous recorded run: this "
                    "run's output .dbg is byte-identical (sha256) to "
                    "the one parity-checked against the reference"
                )
        except (OSError, ValueError, KeyError) as e:
            print(f"parity carry skipped: {e}", flush=True)
    print(json.dumps(res), flush=True)
    json.dump(res, open(res_path, "w"), indent=2)


if __name__ == "__main__":
    main()
