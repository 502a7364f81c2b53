"""Benchmark: end-to-end junction enumeration throughput on one GPU.

Prints JSON lines; the LAST line is the result:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Workload: the BASELINE_MEASURED.json dataset (8 x 8 Mbase synthetic
pangenome, 1% SNP, k=25, f=30) — the same input measured on the
reference C++ binary (scripts/measure_baseline.py, on a 4-core host).
vs_baseline is our bases/s divided by the reference's best
multithreaded bases/s there.

Phases:
  - Phase 0 "insurance": a 2 Mbase run on the small shape tier
    (2048x256 / 2^22), emitted as soon as it is timed.
  - Phase 1 "tier22": the full 64 Mbase dataset on the 2^22 sort tier
    (the shapes cold CLI runs use).
  - Phase 2 "tier26": the 2^26 one-big-sort tier (the serve daemon's).
  - Each phase is one warmup run (compiles included) and then timed
    runs of the same input; EVERY completed run updates the
    best-so-far line, and a timed run always outranks a warmup.
  - A watchdog prints the best-so-far JSON line at
    TWOPACO_BENCH_DEADLINE_S (default 780s) from process start, marked
    "cut_in_phase"; it exits 0 if a timed run had finished, else 1.
  - A failed phase, or a backend other than the GPU, exits 1.

Reported value: best (minimum wall-clock) of the timed runs across all
phases. `detail` names the card (nvidia-smi name and power limit) and
the JAX device the run used.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

K, F = 25, 30
FA = os.path.join(tempfile.gettempdir(), "twopaco_bench.fa")
OUT = os.path.join(tempfile.gettempdir(), "twopaco_bench.dbg")
TIMED_RUNS = {"insurance-2Mbase-tier22": 1, "64Mbase-tier22": 3,
              "64Mbase-tier26": 5}

_T0 = time.monotonic()
_DEADLINE_S = float(os.environ.get("TWOPACO_BENCH_DEADLINE_S", 780))

# best-so-far result dict; the watchdog prints it if time runs out
_best_lock = threading.Lock()
_best_line: dict | None = None
_best_bps = -1.0  # bases/s of the best line
_best_is_warmup = True  # timed runs always supersede warmup seeds
_phase = ""  # the phase running now, named if the deadline cuts it


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _offer_best(obj: dict, bps: float, warmup: bool) -> bool:
    """Update best-so-far; timed beats warmup, then higher bases/s."""
    global _best_line, _best_bps, _best_is_warmup
    with _best_lock:
        better = (_best_is_warmup and not warmup) or (
            _best_is_warmup == warmup and bps > _best_bps
        )
        if better:
            _best_line, _best_bps, _best_is_warmup = obj, bps, warmup
        return better


def _remaining() -> float:
    return _DEADLINE_S - (time.monotonic() - _T0)


def _watchdog() -> None:
    rem = _remaining()
    if rem > 0:
        time.sleep(rem)
    with _best_lock:
        timed = _best_line is not None and not _best_is_warmup
        line = dict(_best_line or {
            "metric": "junction enumeration throughput",
            "value": 0,
            "unit": "Mbases/s/chip",
            "vs_baseline": None,
            "error": f"bench deadline {_DEADLINE_S:.0f}s hit before any "
            "timed run finished",
        }, cut_in_phase=_phase)
    _emit(line)
    sys.stdout.flush()
    os._exit(0 if timed else 1)


def _result_line(
    dt: float,
    enum,
    total_bases: int,
    vs_base,
    phase: str,
    runs_s: list,
    warm_s: float,
    warmup: bool,
    card: str,
) -> dict:
    import jax

    line = {
        "metric": "junction enumeration throughput (end-to-end, "
        f"k={K} f={F}, {total_bases/1e6:.0f} Mbase pangenome)",
        "value": round(total_bases / dt / 1e6, 3),
        "unit": "Mbases/s/chip",
        "vs_baseline": vs_base(total_bases / dt),
        "detail": {
            "seconds": round(dt, 2),
            "phase": phase,
            "convention": "best (min wall-clock) of timed runs of the "
            "same input across all phases; warmup runs only seed "
            "best-so-far and never outrank a timed run",
            "phase_runs_seconds": [round(r, 2) for r in runs_s],
            "warmup_seconds": round(warm_s, 2),
            "distinct_junctions": enum.vertices_count,
            "occurrences": enum.stats.occurrences,
            "card": card,
            "device": {
                "platform": jax.devices()[0].platform,
                "kind": jax.devices()[0].device_kind,
                "count": len(jax.devices()),
            },
            "timings": {
                k: round(v, 2) for k, v in enum.stats.timings.items()
            },
        },
    }
    if warmup:
        line["detail"]["warmup_only"] = True
    return line


def _release_daemon() -> None:
    """A running serve daemon (cli/serve.py) holds most of the card's
    memory, so this process could not allocate; ask it to exit."""
    import socket
    import struct

    from twopaco_tpu.cli.serve import DEFAULT_SOCKET as path

    if not os.path.exists(path):
        return
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(10)
        s.connect(path)
        req = b'{"tool": "__shutdown__", "argv": []}'
        s.sendall(struct.pack("<I", len(req)) + req)
        s.recv(16)
        s.close()
        time.sleep(2)  # let the daemon's device client release the card
    except OSError:
        pass


def _run_phase(
    name: str,
    n_seqs: int,
    length: int,
    positions: int,
    rows: int,
    sort_chunk: int,
    card: str,
    vs_base,
    log,
) -> None:
    """Warmup + timed runs for one shape tier; updates best-so-far."""
    global _phase
    _phase = name
    from twopaco_tpu.passes import PipelineConfig, build_junctions
    from twopaco_tpu.testing.bench_data import write_bench_fasta

    total_bases = n_seqs * length
    fa = FA if (n_seqs, length) == (8, 8_000_000) else os.path.join(
        tempfile.gettempdir(), f"twopaco_bench_{n_seqs}x{length}.fa"
    )
    write_bench_fasta(fa, n_seqs=n_seqs, length=length)

    cfg = PipelineConfig(
        k=K,
        filter_bits=F,
        layout="byte",
        positions_per_row=positions,
        rows_per_batch=rows,
        sort_chunk=sort_chunk,
    )

    t0 = time.time()
    enum = build_junctions([fa], cfg, out_path=OUT, log=log)
    warm_s = time.time() - t0
    # warmup seeds best-so-far: its throughput (compiles included) is a
    # valid lower bound, so the watchdog never reports 0 past this point
    _offer_best(
        _result_line(
            warm_s, enum, total_bases, vs_base, name, [], warm_s, True, card
        ),
        total_bases / warm_s,
        warmup=True,
    )

    runs = []
    for _ in range(TIMED_RUNS[name]):
        # margin check: don't start a run that would cross the deadline
        margin = 1.5 * max([r[0] for r in runs] + [warm_s * 0.5])
        if _remaining() < margin:
            break
        t0 = time.time()
        enum = build_junctions([fa], cfg, out_path=OUT, log=log)
        runs.append((time.time() - t0, enum))
        dt, best_enum = min(runs, key=lambda r: r[0])
        line = _result_line(
            dt, best_enum, total_bases, vs_base, name,
            [r[0] for r in runs], warm_s, False, card,
        )
        if _offer_best(line, total_bases / dt, warmup=False) and (
            len(runs) == 1
        ):
            # early emit: a timed line survives a driver kill
            _emit(line)


def main() -> int:
    quick = "--quick" in sys.argv
    _release_daemon()  # before this process starts its device client
    import jax

    from twopaco_tpu.testing.device import card_labels

    if jax.default_backend() != "gpu":
        print(
            f"bench.py measures the GPU; JAX's backend is "
            f"{jax.default_backend()!r}",
            file=sys.stderr,
        )
        return 1
    card = card_labels()[0]
    threading.Thread(target=_watchdog, daemon=True).start()

    log = (lambda s: print(s, file=sys.stderr, flush=True)) if (
        "--verbose" in sys.argv
    ) else (lambda s: None)

    baseline_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json"
    )
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            base = json.load(f)
        ref = max(v["bases_per_sec"] for v in base["reference"].values())
        vs_base = lambda bps: round(bps / ref, 3)  # noqa: E731
    else:
        vs_base = lambda bps: None  # noqa: E731

    # Phase 0 — insurance: tiny input, small shape tier
    _run_phase(
        "insurance-2Mbase-tier22", 2, 1_000_000, 2048, 256, 1 << 22,
        card, vs_base, log,
    )
    with _best_lock:
        line0 = _best_line
    if line0:
        _emit(line0)
    if quick:
        return 0

    # Phase 1 — full dataset, 2^22 sort tier; phase 2 — the 2^26
    # one-big-sort tier, with margin to spare
    skipped = []
    for name, sort_chunk, margin_s in (
        ("64Mbase-tier22", 1 << 22, 120),
        ("64Mbase-tier26", 1 << 26, 180),
    ):
        if _remaining() > margin_s:
            _run_phase(
                name, 8, 8_000_000, 16384, 128, sort_chunk, card, vs_base,
                log,
            )
        else:
            skipped.append(name)

    with _best_lock:
        final = _best_line
    _emit(dict(final, skipped_phases=skipped) if skipped else final)
    return 0


if __name__ == "__main__":
    sys.exit(main())
