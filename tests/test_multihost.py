"""REAL multi-process multi-host validation (2 processes x 4 virtual
CPU devices, jax.distributed over localhost).

The degenerate single-process path of parallel/multihost.py is covered
elsewhere; these tests spawn genuinely separate OS processes that
rendezvous through the same jax.distributed machinery a multi-host
cluster uses, so per-host input sharding (make_array_from_process_local_data),
cross-process all_to_all record routing, process-0 writer gating, and
barrier-ordered checkpoint files are all exercised for real. Output
must be byte-identical to the single-device sort engine (this
framework's runs are deterministic by construction)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from twopaco_tpu import dna
from twopaco_tpu.passes import PipelineConfig, build_junctions
from twopaco_tpu.testing import oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mh_worker.py")

CONFIG = dict(
    k=9,
    rounds=2,
    positions_per_row=128,
    rows_per_batch=8,
)


def _corpus(seed=11, n=3, length=1500, snp=0.05, ins=0.1):
    rng = np.random.default_rng(seed)
    base = oracle.generate_sequence(rng, length)
    seqs = [base]
    for _ in range(1, n):
        seqs.append(oracle.mutate_sequence(rng, base, snp, ins))
    return seqs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env(port: int, pid: int, n_proc: int, spec: dict) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # each process owns 4 virtual devices -> 8 global, same collective
    # timeout raises as conftest.py (virtual devices on a small host)
    env["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4"
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
        " --xla_cpu_collective_call_terminate_timeout_seconds=3600"
    )
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = str(n_proc)
    env["JAX_PROCESS_ID"] = str(pid)
    env["TWOPACO_MH_SPEC"] = json.dumps(spec)
    return env


def _launch(spec: dict, n_proc: int = 2, timeout: float = 600.0):
    port = _free_port()
    spec = dict(spec, num_processes=n_proc)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER],
            env=_worker_env(port, pid, n_proc, spec),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(n_proc)
    ]
    results = {}
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        line = [l for l in out.splitlines() if l.startswith("MH_RESULT ")]
        assert line, f"worker {pid} printed no result:\n{out[-4000:]}"
        results[pid] = json.loads(line[-1][len("MH_RESULT "):])
    return results


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    """Shared FASTA + single-device golden .dbg for all tests here."""
    tmp = tmp_path_factory.mktemp("mh")
    fa = str(tmp / "in.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(_corpus()):
            f.write(f">chr{i}\n{s}\n")
    golden = str(tmp / "golden.dbg")
    enum = build_junctions(None, PipelineConfig(**CONFIG), out_path=golden,
                           sequences=_encoded())
    return fa, golden, enum.vertices_count, tmp


def _encoded():
    return [(i, dna.encode(s)) for i, s in enumerate(_corpus())]


def test_two_process_byte_identical(fixture_paths):
    fa, golden, n_vert, tmp = fixture_paths
    out = str(tmp / "mh.dbg")
    results = _launch({"fa": fa, "out": out, "config": CONFIG})
    # the rendezvous really was 2 processes x 4 local = 8 global devices
    for pid, r in results.items():
        assert r["process"] == pid
        assert r["processes"] == 2
        assert r["local_devices"] == 4
        assert r["global_devices"] == 8
        assert r["vertices"] == n_vert
    # single writer: process 0 produced the file, byte-identical to the
    # single-device engine
    with open(out, "rb") as f1, open(golden, "rb") as f2:
        assert f1.read() == f2.read()


def test_two_process_bloom_gate_byte_identical(fixture_paths):
    """engine="dist-bloom" across REAL processes: the hash-sharded
    Bloom filter's fill/mark all_to_all collectives cross the process
    boundary, then the gated sort-join tail must still produce bytes
    identical to the single-device engine."""
    fa, golden, n_vert, tmp = fixture_paths
    out = str(tmp / "mh_bloom.dbg")
    results = _launch(
        {"fa": fa, "out": out, "config": CONFIG, "bloom_gate": True}
    )
    for r in results.values():
        assert r["vertices"] == n_vert
    with open(out, "rb") as f1, open(golden, "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("bloom_gate", [False, True])
def test_two_process_wide_positions_byte_identical(
    fixture_paths, bloom_gate
):
    """u32-pair (wide) routed positions across REAL processes: the
    >=4.2 Gbase record layout (distpipe's second position column rides
    the all_to_all routing) must produce bytes identical to the
    narrow single-device engine — with and without the sharded Bloom
    gate. Forced via PipelineConfig.force_wide on a small corpus."""
    fa, golden, n_vert, tmp = fixture_paths
    out = str(tmp / f"mh_wide{int(bloom_gate)}.dbg")
    results = _launch(
        {
            "fa": fa,
            "out": out,
            "config": dict(CONFIG, force_wide=True),
            "bloom_gate": bloom_gate,
        }
    )
    for r in results.values():
        assert r["vertices"] == n_vert
    with open(out, "rb") as f1, open(golden, "rb") as f2:
        assert f1.read() == f2.read()


def test_two_process_checkpoint_resume(fixture_paths):
    fa, golden, n_vert, tmp = fixture_paths
    out = str(tmp / "mh_ck.dbg")
    ckdir = str(tmp / "ck")
    spec = {"fa": fa, "out": out, "config": CONFIG,
            "checkpoint_dir": ckdir}
    _launch(spec)
    saved = sorted(os.listdir(ckdir))
    assert any(s.startswith("round_") for s in saved), saved
    with open(out, "rb") as f:
        first = f.read()
    with open(golden, "rb") as f:
        assert first == f.read()
    # fresh process pair resumes from the barrier-ordered round files
    # (every round restored) and must reproduce the same bytes
    os.unlink(out)
    _launch(spec)
    with open(out, "rb") as f:
        assert f.read() == first
