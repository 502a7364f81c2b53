"""twopaco_tpu — compacted de Bruijn graph constructor in JAX.

A from-scratch JAX/XLA framework with the capabilities of
medvedevgroup/TwoPaCo: streamed multi-FASTA input, two-pass junction
detection via a multi-hash Bloom filter over (k+1)-mer edges with exact
sorted verification of candidates, multi-round operation to bound
memory, the 12-byte binary junction-position output format, and a
graphdump converter (seq/group/dot/gfa1/gfa2/fasta). Its accelerator is
an NVIDIA GPU; every device operation is plain jax.numpy/lax under jit.

Architecture (a redesign, not a port):
  - host io layer parses FASTA to 2-bit codes and batches fixed-size
    windows with k+1-char halos (reference: vertexenumerator.h:1108-1226);
  - all per-position work (k-mer packing, canonical reverse complement,
    hashing, Bloom probes) is vectorized JAX integer math over
    (batch, positions) arrays — no rolling scan, every position computed
    independently;
  - the default engine sorts one record per position and judges
    junctions with segmented scans (passes/sortpipe.py); the Bloom
    engine keeps the filter in device memory as a flat array, fill is a
    scatter, probe is a gather (reference: concurrentbitvector.h);
  - exact candidate verification replaces the reference's 1024 mutexed
    hash tables (vertexenumerator.h:63-90) with a device sort + segmented
    reduction;
  - junction ids are ranks in the sorted canonical k-mer dictionary,
    making runs bit-deterministic (the reference is seeded from
    /dev/urandom and is not; see SURVEY.md §5).
"""

import os as _os


def _retain_heap() -> None:
    """Keep freed large allocations in the process heap.

    glibc serves >128KB allocations via mmap and returns them to the OS
    on free; on VMs whose memory is demand-faulted from the hypervisor
    (first touch of a new page measured at ~70-100us here), that makes
    every large numpy temporary re-fault its pages — array passes ran
    30-50x slower than warm-memory reruns. Raising the mmap/trim
    thresholds makes the heap retain and reuse warmed pages; RSS stays
    high, which is the intended trade. TWOPACO_RETAIN_HEAP=0 disables.
    """
    if _os.environ.get("TWOPACO_RETAIN_HEAP", "1") == "0":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        # INT_MAX: even ~1-2 GB occurrence-stream temporaries (62-strain
        # pangenomes hit 40%+ junction-occurrence density) must come
        # from the retained heap, not fresh cold-faulted mmaps
        libc.mallopt(M_MMAP_THRESHOLD, 0x7FFFFFFF)
        libc.mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF)
    except Exception:
        pass  # non-glibc platforms: default allocator behavior


_retain_heap()

import jax as _jax

# All k-mer/hash math is explicit fixed-width integer arithmetic; several
# paths (filter indices beyond 2^32, the int64 junction id format) need
# 64-bit types, so x64 must be on before any tracing happens.
_jax.config.update("jax_enable_x64", True)

# Persistent compile cache: CLI processes are short-lived, and each would
# otherwise pay every XLA compile again. JAX_COMPILATION_CACHE_DIR, when
# set, is JAX's own setting and is left alone; otherwise the cache lives
# at one fixed directory inside the checkout (a cache directory that
# moves between runs is never hit again).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
# 0.5 s keeps the pipeline's large programs without churning tiny entries
# (JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS overrides it; the test
# suite sets 0, because its wall time is thousands of small compiles)
if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in _os.environ:
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"

INVALID_VERTEX = (1 << 63) - 1  # reference: common.cpp:5 (INT64_MAX)
