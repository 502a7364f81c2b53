"""twopaco CLI: junction enumeration (reference constructor.cpp:53-176).

Flag-compatible with the reference binary:
    -k/--kvalue, -f/--filtersize XOR --filtermemory, -q/--hashfnumber,
    -r/--rounds, -t/--threads, -a/--abundance, --tmpdir, --test,
    -o/--outfile, positional FASTA files.
Device-engine extras are prefixed --tpu-* (a historical name).
"""

from __future__ import annotations

import argparse
import math
import os
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="twopaco",
        description=(
            "Program for construction of the condensed de Bruijn graph "
            "from complete genomes (JAX)"
        ),
    )
    p.add_argument("-k", "--kvalue", type=int, default=25, help="Value of k (odd)")
    p.add_argument(
        "-f", "--filtersize", type=int, default=None,
        help="Size of the filter (log2 of slot count)",
    )
    p.add_argument(
        "--filtermemory", type=float, default=None,
        help="Memory in GBs allocated for the filter",
    )
    p.add_argument(
        "-q", "--hashfnumber", type=int, default=5,
        help="Number of hash functions",
    )
    p.add_argument(
        "-r", "--rounds", type=int, default=1,
        help="Number of computation rounds",
    )
    p.add_argument(
        "-t", "--threads", type=int, default=1,
        help="Number of worker threads (accepted for compatibility; "
        "parallelism is XLA/device-driven here)",
    )
    p.add_argument(
        "-a", "--abundance", type=int, default=(1 << 64) - 1,
        help="Vertex abundance threshold",
    )
    p.add_argument(
        "--tmpdir", default=".", help="Temporary directory name"
    )
    p.add_argument("--test", action="store_true", help="Run tests")
    p.add_argument(
        "-o", "--outfile", default="de_bruijn.bin",
        help="Output file name prefix",
    )
    p.add_argument(
        "--tpu-profile", default=None, metavar="DIR",
        help="Write a jax.profiler trace of the run to DIR",
    )
    p.add_argument(
        "--tpu-checkpoint", default=None, metavar="DIR",
        help="Round-boundary checkpoint directory (resume on rerun)",
    )
    p.add_argument(
        "--tpu-engine",
        choices=["sort", "bloom", "dist", "dist-bloom"],
        default="sort",
        help="Device engine: sort-join (default), Bloom two-pass, "
        "mesh-distributed sort-join, or mesh-distributed Bloom "
        "(sharded filter gate + distributed sort-join verify/emit)",
    )
    p.add_argument(
        "--tpu-layout",
        choices=["auto", "byte", "bit", "block"],
        default="auto",
        help="Bloom filter memory layout (block = vertex-blocked: one "
        "word gather tests all 8 edge extensions of a position; "
        "single-chip bloom engine only)",
    )
    p.add_argument(
        "--tpu-positions", type=int, default=None,
        help="Window positions per row (default: auto by input size)",
    )
    p.add_argument(
        "--tpu-rows", type=int, default=None,
        help="Rows per batch (default: auto by input size)",
    )
    p.add_argument(
        "--tpu-sort-chunk", type=int, default=None,
        help="Max records per round sort (sort engine). Default is "
        "tiered: 2^22 for cold-CLI inputs under 1 GB (small programs "
        "load instantly), 2^26 for bigger inputs and for the resident "
        "serve daemon (TWOPACO_SORT_CHUNK pins it), matching the "
        "library default in PipelineConfig.sort_chunk",
    )
    p.add_argument(
        "--tpu-wide", action="store_true",
        help="Force u32-pair (wide) positions even below 4.2 Gbases "
        "(pre-compiles the big-input programs on small inputs)",
    )
    p.add_argument("filenames", nargs="*", help="FASTA file(s)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)

    if args.test:
        from twopaco_tpu.testing.selftest import run_tests

        # reference sweep: constructor.cpp:147 (defaults of run_tests)
        ok = run_tests(tmpdir=args.tmpdir if args.tmpdir != "." else None)
        return 0 if ok else 1

    if args.kvalue % 2 != 1:
        print("Error: value of K must be odd", file=sys.stderr)
        return 1
    if not args.filenames:
        print("Error: no input files", file=sys.stderr)
        return 1
    if (args.filtersize is None) == (args.filtermemory is None):
        print(
            "Error: exactly one of -f/--filtersize or --filtermemory "
            "is required",
            file=sys.stderr,
        )
        return 1
    if args.filtersize is not None:
        filter_bits = args.filtersize
    else:
        # identical to the reference conversion (constructor.cpp:158):
        # int64_t filterBits = log2(GB * 8e+9) — decimal GB, the double
        # log2 truncated toward zero
        filter_bits = int(math.log2(args.filtermemory * 8e9))

    from twopaco_tpu.passes import PipelineConfig, build_junctions

    # batch-shape auto-tier: every batch costs dispatches, so big
    # inputs get 2M-position batches (the bench.py shape), while small
    # ones keep the small program whose compile-cache read is cheaper.
    # Fixed tiers (not proportional sizing) keep jit shapes stable
    # across runs so the persistent compile cache always hits. The
    # tiers have not been re-timed on the GPU (ROADMAP.md).
    positions, rows = args.tpu_positions, args.tpu_rows
    try:
        total_sz = sum(os.path.getsize(f) for f in args.filenames)
    except OSError:
        total_sz = 0
    if positions is None or rows is None:
        tier = (16384, 128) if total_sz >= (64 << 20) else (2048, 256)
        positions = positions if positions is not None else tier[0]
        rows = rows if rows is not None else tier[1]

    extra = {}
    if args.tpu_sort_chunk is not None:
        extra["sort_chunk"] = args.tpu_sort_chunk
    elif os.environ.get("TWOPACO_SORT_CHUNK"):
        # the serve daemon pins the big buffer: its process is resident,
        # so the one-time compile (or cache load) amortizes across
        # requests
        extra["sort_chunk"] = int(os.environ["TWOPACO_SORT_CHUNK"])
    elif total_sz < (1 << 30):
        # cold CLI on small/mid inputs: big sort programs execute
        # faster but cost more to compile or load per process, so many
        # small rounds were chosen for a process that dies after one
        # run; Gbase-scale runs amortize the load and keep the library
        # default (2^26). Whether the split still pays on the GPU is to
        # be timed (ROADMAP.md).
        extra["sort_chunk"] = 1 << 22
    cfg = PipelineConfig(
        k=args.kvalue,
        filter_bits=filter_bits,
        hash_functions=args.hashfnumber,
        rounds=args.rounds,
        abundance=args.abundance,
        layout=args.tpu_layout,
        positions_per_row=positions,
        rows_per_batch=rows,
        engine=args.tpu_engine,
        force_wide=args.tpu_wide,
        **extra,
    )
    try:
        enum = build_junctions(
            args.filenames,
            cfg,
            out_path=args.outfile,
            log=print,
            profile_dir=args.tpu_profile,
            checkpoint_dir=args.tpu_checkpoint,
            tmpdir=args.tmpdir if args.tmpdir != "." else None,
        )
    except (OSError, RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Distinct junctions = {enum.vertices_count}")
    # phase wall-clock table (the reference prints coarse per-pass
    # times, constructor.cpp: "Filling up the filter"/... — ours is the
    # host-truth breakdown; rounds' dispatch walls are summed)
    st = getattr(enum, "stats", None)
    if st is not None and st.timings:
        rsum: dict[str, float] = {}
        for r in st.rounds or ():
            for key in ("t_build", "t_sort", "t_finish"):
                if key in r:
                    rsum[key] = rsum.get(key, 0.0) + r[key]
        for name, val in {**st.timings, **rsum}.items():
            print(f"time\t{name}\t{val:.2f}")
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
