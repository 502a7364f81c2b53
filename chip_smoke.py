"""Smoke test of the junction pipeline on an NVIDIA GPU.

Drives the main path once through the entry points a user calls and
checks every result. Phases, in the order they run:

  a. device: JAX's default backend must be the GPU. A child process
     checks it, so this process stays off the card until the served
     phase is done (a JAX process reserves most of the card's memory).
     Prints nvidia-smi's name and power limit and the device kind.
  d. served: the serve daemon (cli/serve.py) and native/build/tpclient
     build a 4.6 Mbase genome (E. coli-sized, BASELINE.md config 2) at
     k=25, f=34, cold then warm; the daemon is shut down (__shutdown__)
     before this process starts its own device client.
  b. golden parity: the twopaco CLI at k=11 and 25 on
     tests/golden/example.fa and at k=101, 129, 311, 603 on
     tests/golden/largek.fa, against the reference goldens
     (twopaco_tpu/testing/golden.py).
  c. oracle: the CLI's randomized self-test (`twopaco --test`), exact
     against testing/oracle.find_junctions_naively.
  d. scale: the 64 Mbase 8-genome 1%-SNP pangenome at k=25, one round
     (cold, then warm) and -r 4 (resident multi-round), byte-identical;
     the 4.6 Mbase genome in-process with the sort engine and with
     --tpu-engine bloom, byte-identical to the served output; graphdump
     gfa1 of it must spell the genome back.
  e. trace: a --tpu-profile run must leave a jax.profiler trace with
     events on the GPU.

--multi runs only the multi-device check instead, on 4 or more GPUs:
--tpu-engine dist and dist-bloom over every visible GPU on the 64 Mbase
pangenome, each byte-identical to the single-device sort engine.

The last line of stdout is {"ok": true, "device": {...}}. A failed phase
exits 1 without it.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TPCLIENT = os.path.join(REPO, "native", "build", "tpclient")
K, F_SORT, F_ECOLI = 25, 30, 34
ECOLI_BASES = 4_600_000
PANGENOME = dict(n_seqs=8, length=8_000_000)  # 64 Mbase, 1% SNP
GOLDEN_RUNS = (
    ("example.fa", "example_k11", 11),
    ("example.fa", "example_k25", 25),
    ("largek.fa", "largek_k101", 101),
    ("largek.fa", "largek_k129", 129),
    ("largek.fa", "largek_k311", 311),
    ("largek.fa", "largek_k603", 603),
)
_PROBE = (
    "import json, jax; d = jax.devices(); print(json.dumps({"
    "'backend': jax.default_backend(), 'platform': d[0].platform, "
    "'kind': d[0].device_kind, 'count': len(d)}))"
)


class SmokeError(Exception):
    """A phase's result was wrong or its command failed."""


def say(msg: str) -> None:
    print(msg, flush=True)


def probe_device() -> dict:
    """Phase a, in a child process: the backend JAX picks by default."""
    r = subprocess.run(
        [sys.executable, "-c", _PROBE],
        capture_output=True, text=True, timeout=300,
    )
    if r.returncode != 0:
        raise SmokeError(f"JAX device probe failed:\n{r.stderr[-2000:]}")
    dev = json.loads(r.stdout.strip().splitlines()[-1])
    if dev["backend"] != "gpu":
        raise SmokeError(
            f"JAX's default backend is {dev['backend']!r}, not 'gpu' "
            "(no GPU, or its CUDA plugin failed to start)"
        )
    return dev


_COMPILES = {"n": 0, "s": 0.0}  # XLA compiles during the last run_cli
_listening = False


def _count_compile(event: str, duration: float, **_) -> None:
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILES["n"] += 1
        _COMPILES["s"] += duration


def compile_note() -> str:
    return f"{_COMPILES['n']} XLA compiles, {_COMPILES['s']:.2f} s"


def run_cli(argv: list[str]) -> tuple[float, str]:
    """The twopaco CLI in this process: (seconds, its output)."""
    import jax

    from twopaco_tpu.cli import twopaco

    global _listening
    if not _listening:
        jax.monitoring.register_event_duration_secs_listener(_count_compile)
        _listening = True
    _COMPILES.update(n=0, s=0.0)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = twopaco.main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise SmokeError(
            f"twopaco {' '.join(argv)} exited {rc}:\n{buf.getvalue()[-3000:]}"
        )
    return dt, buf.getvalue()


def require_same(a: str, b: str) -> None:
    from twopaco_tpu.testing.golden import first_difference

    diff = first_difference(a, b)
    if diff is not None:
        raise SmokeError(diff)


def gfa_spells(text: str, fasta: str, k: int) -> list[str]:
    """Walk each GFA1 path, overlapping segments by k: every input
    chromosome must come back (the glueGfa1.py check of the reference)."""
    from twopaco_tpu.formats.graphdump import _revcomp_text
    from twopaco_tpu.io import fasta as fasta_io

    body, paths = {}, {}
    for line in text.splitlines():
        f = line.split("\t")
        if f[0] == "S" and len(f) == 3:
            body[int(f[1])] = f[2]
        elif f[0] == "P":
            paths[f[1]] = f[2].split(",")
    problems = []
    for hdr, codes in fasta_io.read_fasta(fasta):
        parts = []
        for step in paths.get(hdr, ()):
            seg = body[int(step[:-1])]
            if step[-1] == "-":
                seg = _revcomp_text(seg)
            if parts and parts[-1][-k:] != seg[:k]:
                problems.append(f"{hdr}: segments do not overlap by k")
                break
            parts.append(seg if not parts else seg[k:])
        want = "".join("ACGTN"[c] for c in codes.tolist())
        if "".join(parts) != want:
            problems.append(f"{hdr}: GFA1 path does not spell the input")
    return problems


def _request(sock: str, tool: str, argv: list[str]) -> None:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(60)
        s.connect(sock)
        req = json.dumps({"tool": tool, "argv": argv}).encode()
        s.sendall(struct.pack("<I", len(req)) + req)
        s.recv(16)


def served_phase(work: str, fa: str, label: str) -> tuple[str, list[str]]:
    """Phase d, served: daemon + native client, cold then warm. Returns
    the daemon's ready line and the .dbg paths it wrote."""
    sock = os.path.join(work, "tp.sock")
    log_path = os.path.join(work, "serve.log")
    env = dict(
        os.environ,
        TWOPACO_SERVER_SOCKET=sock,
        # a lost daemon must fail the request, not boot a second one
        TWOPACO_PYTHON="false",
        TWOPACO_CLIENT_WAIT_S="5",
    )
    with open(log_path, "w") as log_fh:
        daemon = subprocess.Popen(
            [sys.executable, "-m", "twopaco_tpu.cli.serve",
             "--socket", sock, "--idle-timeout", "900"],
            cwd=REPO, env=env, stdout=log_fh, stderr=subprocess.STDOUT,
        )
    try:
        ready = None
        t0 = time.perf_counter()
        while ready is None and time.perf_counter() - t0 < 300:
            if daemon.poll() is not None:
                break
            with open(log_path) as fh:
                ready = next(
                    (ln for ln in fh if ln.startswith("twopaco server ready")),
                    None,
                )
            time.sleep(0.2)
        if ready is None:
            with open(log_path) as fh:
                raise SmokeError(f"serve daemon not ready:\n{fh.read()[-3000:]}")
        ready = ready.strip()
        say(f"daemon: {ready} after {time.perf_counter() - t0:.2f} s")
        outs = []
        for run in ("cold", "warm"):
            out = os.path.join(work, f"served_{run}.dbg")
            t0 = time.perf_counter()
            r = subprocess.run(
                [TPCLIENT, "twopaco", "-k", str(K), "-f", str(F_ECOLI),
                 "-o", out, fa],
                env=env, capture_output=True, text=True, timeout=900,
            )
            dt = time.perf_counter() - t0
            if r.returncode != 0:
                raise SmokeError(
                    f"tpclient exited {r.returncode}:\n{r.stderr[-3000:]}"
                )
            say(f"{label} | served {ECOLI_BASES / 1e6} Mbase k=25 f=34 ({run}): {dt:.2f} s")
            outs.append(out)
        require_same(outs[0], outs[1])
        _request(sock, "__shutdown__", [])
        if daemon.wait(timeout=120) != 0:
            raise SmokeError(f"serve daemon exited {daemon.returncode}")
        return ready, outs
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()


def golden_phase(work: str, label: str) -> None:
    """Phase b: junctions and graphdump against the reference goldens."""
    from twopaco_tpu.testing import golden

    for fa_name, name, k in GOLDEN_RUNS:
        fa = os.path.join(golden.GOLDEN_DIR, fa_name)
        out = os.path.join(work, f"{name}.dbg")
        dt, _ = run_cli(["-k", str(k), "-f", "20", fa, "-o", out])
        problems = golden.junction_parity(out, name)
        if os.path.exists(os.path.join(golden.GOLDEN_DIR, f"{name}.dbg")):
            problems += golden.graphdump_parity(name, k, fa)
        if problems:
            raise SmokeError("; ".join(problems))
        say(f"{label} | golden {name}: parity ok ({dt:.2f} s; {compile_note()})")


def oracle_phase(label: str) -> None:
    """Phase c: the CLI self-test sweep against the naive oracle."""
    dt, out = run_cli(["--test"])
    passed = out.count("PASSED")
    say(
        f"{label} | twopaco --test: {passed} tests passed "
        f"({dt:.2f} s; {compile_note()})"
    )


def scale_phase(work: str, ecoli: str, served: list[str], label: str) -> str:
    """Phase d, in-process. Returns the E. coli .dbg path."""
    from twopaco_tpu.io import native
    from twopaco_tpu.testing import golden
    from twopaco_tpu.testing.bench_data import write_bench_fasta

    if not native.available():
        raise SmokeError("the native FASTA library did not load")
    say("FASTA parser: native (native/build/libtwopaco_io.so)")

    pan = write_bench_fasta(os.path.join(work, "pan64.fa"), **PANGENOME)
    mbases = PANGENOME["n_seqs"] * PANGENOME["length"] / 1e6
    one_round = ["--tpu-sort-chunk", str(1 << 26)]
    outs = {}
    for run, extra in (
        ("-r 1 cold", ["-r", "1"]),
        ("-r 1 warm", ["-r", "1"]),
        ("-r 4", ["-r", "4"]),
    ):
        out = os.path.join(work, f"pan_{len(outs)}.dbg")
        dt, log = run_cli(
            ["-k", str(K), "-f", str(F_SORT), *one_round, *extra, pan,
             "-o", out]
        )
        rounds = sum(ln.startswith("Round ") for ln in log.splitlines())
        budget = next(
            (ln for ln in log.splitlines() if ln.startswith("Resident")), ""
        )
        say(
            f"{label} | {mbases:.0f} Mbase pangenome k=25 {run}: {dt:.2f} s "
            f"({mbases / dt:.2f} Mbases/s, {rounds} rounds; {budget}; "
            f"{compile_note()})"
        )
        outs[run] = out
    require_same(outs["-r 1 cold"], outs["-r 4"])
    require_same(outs["-r 1 cold"], outs["-r 1 warm"])

    for engine in ("sort", "bloom"):
        out = os.path.join(work, f"ecoli_{engine}.dbg")
        dt, _ = run_cli(
            ["-k", str(K), "-f", str(F_ECOLI), "--tpu-engine", engine,
             ecoli, "-o", out]
        )
        say(
            f"{label} | in-process {ECOLI_BASES / 1e6} Mbase k=25 f=34 "
            f"{engine}: {dt:.2f} s ({compile_note()})"
        )
        require_same(served[0], out)

    t0 = time.perf_counter()
    gfa = golden.render(os.path.join(work, "ecoli_sort.dbg"), "gfa1", K, ecoli)
    dt = time.perf_counter() - t0
    problems = gfa_spells(gfa, ecoli, K)
    if problems:
        raise SmokeError("; ".join(problems))
    say(f"{label} | graphdump gfa1 of {ECOLI_BASES / 1e6} Mbase: {dt:.2f} s, spells it")
    return os.path.join(work, "ecoli_sort.dbg")


def trace_phase(work: str, ecoli: str) -> None:
    """Phase e: --tpu-profile must record device events on the GPU."""
    import jax

    prof = os.path.join(work, "profile")
    run_cli(
        ["-k", str(K), "-f", str(F_ECOLI), "--tpu-profile", prof, ecoli,
         "-o", os.path.join(work, "traced.dbg")]
    )
    files = glob.glob(os.path.join(prof, "**", "*.xplane.pb"), recursive=True)
    if not files or not all(os.path.getsize(f) for f in files):
        raise SmokeError(f"no trace written under {prof}")
    data = jax.profiler.ProfileData.from_file(files[0])
    events = {
        p.name: sum(1 for line in p.lines for _ in line.events)
        for p in data.planes
        if p.name.startswith("/device:GPU")
    }
    if not any(events.values()):
        raise SmokeError(f"trace holds no GPU events (planes: {events})")
    say(f"trace: {os.path.getsize(files[0])} bytes, GPU events {events}")


def multi_phase(work: str, label: str, genomes: dict) -> None:
    """--multi: dist and dist-bloom over every device == one device."""
    import jax

    from twopaco_tpu.testing.bench_data import write_bench_fasta

    pan = write_bench_fasta(os.path.join(work, "pan.fa"), **genomes)
    mbases = genomes["n_seqs"] * genomes["length"] / 1e6
    outs = {}
    for engine in ("dist", "dist-bloom", "sort"):
        out = os.path.join(work, f"{engine}.dbg")
        dt, _ = run_cli(
            ["-k", str(K), "-f", str(F_SORT), "--tpu-engine", engine, pan,
             "-o", out]
        )
        peaks = [
            (d.memory_stats() or {}).get("peak_bytes_in_use", 0) >> 20
            for d in jax.devices()
        ]
        n_dev = 1 if engine == "sort" else len(jax.devices())
        say(
            f"{label} | {mbases:.0f} Mbase k=25 {engine} on {n_dev} "
            f"device(s): {dt:.2f} s ({compile_note()}; "
            f"peak MiB per device so far: {peaks})"
        )
        outs[engine] = out
    require_same(outs["sort"], outs["dist"])
    require_same(outs["sort"], outs["dist-bloom"])


def main(argv: list[str]) -> int:
    multi = "--multi" in argv
    work = tempfile.mkdtemp(prefix="twopaco_smoke_")
    phase = "a: device"
    try:
        dev = probe_device()
        # a copy of this script alone has no package to import
        from twopaco_tpu.testing.device import card_labels

        try:
            cards = card_labels()
        except RuntimeError as e:
            raise SmokeError(str(e)) from None
        for line in cards:
            say(line)
        label = cards[0]
        say(f"JAX: {dev['count']} x {dev['kind']} ({dev['platform']})")

        if multi:
            phase = "multi: dist engines"
            import jax

            if jax.default_backend() != "gpu" or len(jax.devices()) < 4:
                raise SmokeError(
                    f"--multi needs 4 GPUs, JAX has {jax.devices()}"
                )
            multi_phase(work, label, PANGENOME)
        else:
            phase = "build native/"
            subprocess.run(
                ["make", "-C", os.path.join(REPO, "native")],
                check=True, capture_output=True, timeout=300,
            )
            from twopaco_tpu.testing.bench_data import write_bench_fasta

            ecoli = write_bench_fasta(
                os.path.join(work, "ecoli.fa"), n_seqs=1, length=ECOLI_BASES
            )
            phase = "d: served"
            ready, served = served_phase(work, ecoli, label)
            if "(platform gpu," not in ready:
                raise SmokeError("the serve daemon is not on the GPU")

            import jax

            if jax.default_backend() != "gpu":
                raise SmokeError("this process did not get the GPU")
            phase = "b: golden parity"
            golden_phase(work, label)
            phase = "c: oracle"
            oracle_phase(label)
            phase = "d: scale"
            scale_phase(work, ecoli, served, label)
            phase = "e: trace"
            trace_phase(work, ecoli)
    except SmokeError as e:
        print(f"FAILED in phase {phase}: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    import jax

    d = jax.devices()
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
