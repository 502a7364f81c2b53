"""Test harness config: CPU backend with 8 virtual devices.

The suite always runs on the CPU, also on a machine with a GPU: the
platform is forced to cpu before any backend initialization, and
multi-device behavior is tested on host-platform virtual devices
(SURVEY.md §4). GPU runs are `python chip_smoke.py` and `python bench.py`.
"""

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
# 8 virtual-device collectives run their participant threads 4-at-a-time
# on this 4-core host; at >=100M-record scale the first 4 shards' compute
# exceeds XLA:CPU's default 40s rendezvous termination window and the
# watchdog aborts the whole process (rendezvous.cc). These are virtual
# devices on one host — a stuck rendezvous here means slow threads, not
# a dead peer — so give the scale tests an hour.
if "collective_call_terminate" not in _flags:
    _flags += (
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
        " --xla_cpu_collective_call_terminate_timeout_seconds=3600"
    )
os.environ["XLA_FLAGS"] = _flags
# XLA:CPU logs a full-page "AOT machine features" E-line per cache-loaded
# executable (harmless — the cache is written on this same host); silence it
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

# Test wall time is dominated by thousands of small op-by-op CPU compiles
# (the pipelines dispatch eagerly); persist ALL of them across runs — the
# package default (twopaco_tpu/__init__.py) only persists >=0.5s compiles.
# Env (not jax.config) because jax reads it when imported below. They go
# to a directory of their own, so the GPU runs' cache holds only the
# pipeline's programs.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(_REPO, ".jax_cache_cpu")
)

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, _REPO)

import twopaco_tpu  # noqa: F401  (applies the cache settings above)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the reference's example input, rebuilt from the GFA1 paths of its
# k=11 golden (the paths spell both chromosomes)
EXAMPLE_FA = os.path.join(GOLDEN_DIR, "example.fa")
