"""Package start-up settings (twopaco_tpu/__init__.py) and the device
memory budget of the sort engine's resident mode."""

import os
import subprocess
import sys

import numpy as np

from twopaco_tpu import dna
from twopaco_tpu.passes import PipelineConfig, build_junctions, sortpipe
from twopaco_tpu.testing import oracle
from twopaco_tpu.testing.selftest import marks_mismatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHOW_CACHE = (
    "import twopaco_tpu, jax; print(jax.config.jax_compilation_cache_dir)"
)


def _cache_dir(cwd, **env_over):
    env = {
        k: v for k, v in os.environ.items()
        if k != "JAX_COMPILATION_CACHE_DIR"
    }
    env.update(env_over, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _SHOW_CACHE],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout.strip()


def test_compile_cache_env_is_honoured(tmp_path):
    want = str(tmp_path / "my_cache")
    assert _cache_dir(str(tmp_path), JAX_COMPILATION_CACHE_DIR=want) == want


def test_compile_cache_default_is_fixed_in_checkout(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    first, second = _cache_dir(str(a)), _cache_dir(str(b))
    assert first == second == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_resident_budget_scales_with_device_limit():
    # a 16 GiB device keeps the budget the constant used to give it
    assert sortpipe.resident_budget(16 << 30) == 6 << 30
    assert sortpipe.resident_budget(60 << 30) == int((60 << 30) * 3 / 8)
    assert sortpipe.resident_budget(None) == 6 << 30
    assert sortpipe.resident_budget(0) == 6 << 30


def test_resident_bytes_on_cpu_and_override(monkeypatch):
    monkeypatch.delenv("TWOPACO_RESIDENT_BYTES", raising=False)
    assert sortpipe._resident_bytes() == 6 << 30  # CPU reports no limit
    monkeypatch.setenv("TWOPACO_RESIDENT_BYTES", "12345")
    assert sortpipe._resident_bytes() == 12345


def test_tiny_k_rounds_stream_when_blocks_stay_unbalanced(tmp_path):
    """k=3 has 32 canonical k-mers, so no hash split evens out the
    resident per-batch blocks; the rounds must stream instead and still
    match the oracle (the reference's own --test sweeps k=3, -r 2..4)."""
    rng = np.random.default_rng(0)
    base = oracle.generate_sequence(rng, 9000)
    seqs = [base] + [
        oracle.mutate_sequence(rng, base, 0.05, 0.1) for _ in range(5)
    ]
    out = str(tmp_path / "k3.dbg")
    logs = []
    build_junctions(
        None,
        PipelineConfig(k=3, rounds=2, positions_per_row=512, rows_per_batch=8),
        out_path=out,
        sequences=[(i, dna.encode(s)) for i, s in enumerate(seqs)],
        log=logs.append,
    )
    assert any("streaming the rounds instead" in s for s in logs)
    _junc, want = oracle.find_junctions_naively(seqs, 3)
    assert marks_mismatch(out, want) is None
