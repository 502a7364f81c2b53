"""Subprocess entry for the REAL multi-process multi-host tests.

tests/test_multihost.py launches N of these, one per simulated host,
each owning a disjoint set of virtual CPU devices
(--xla_force_host_platform_device_count). They rendezvous through
jax.distributed (Gloo over localhost TCP — the same client/coordinator
machinery a multi-host cluster uses), so collectives genuinely cross process
boundaries: this is the closest a single machine gets to validating
parallel/multihost.py's per-host sharding, cross-process all_to_all
routing, process-0 writer gating, and barrier-ordered checkpoints.

All parameters arrive in the TWOPACO_MH_SPEC env var (JSON); the
coordinator address / process count / process id arrive in the standard
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID vars that
twopaco_tpu.parallel.multihost.initialize() reads.
"""

import json
import os
import sys


def main() -> None:
    spec = json.loads(os.environ["TWOPACO_MH_SPEC"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from twopaco_tpu.parallel import multihost

    multihost.initialize()
    assert jax.process_count() == spec["num_processes"], (
        jax.process_count(),
        spec["num_processes"],
    )

    from twopaco_tpu.passes import PipelineConfig

    config = PipelineConfig(**spec["config"])
    enum = multihost.build_junctions_multihost(
        [spec["fa"]],
        config,
        out_path=spec["out"],
        checkpoint_dir=spec.get("checkpoint_dir"),
        bloom_gate=spec.get("bloom_gate", False),
    )
    # one machine-readable result line per process (parent asserts on it)
    print(
        "MH_RESULT "
        + json.dumps(
            {
                "process": jax.process_index(),
                "processes": jax.process_count(),
                "global_devices": jax.device_count(),
                "local_devices": jax.local_device_count(),
                "vertices": enum.vertices_count,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
