"""Multi-chip sharding: hash-prefix-sharded Bloom filter + routed probes.

The reference has no distributed layer at all (SURVEY.md §2.4: one
process, pthreads, atomics); this module introduces it over a device
mesh:

  mesh axis 'shard' plays two roles at once —
    * window batches are data-parallel over it (rows split on axis 0);
    * the Bloom filter is model-parallel over it: device d owns the
      slot range [d·S, (d+1)·S), S = 2^f / D — the hash PREFIX picks
      the owner, the suffix is the in-shard slot.

  Every fill/probe therefore becomes: bucket the locally generated hash
  values by owner prefix, exchange buckets with jax.lax.all_to_all (NVLink
  between the GPUs of one host), operate on the local shard, and (for probes) all_to_all the hit
  bits back along the inverse permutation. This is the direct analogue
  of the reference's multi-round hash-interval trick
  (vertexenumerator.h:176-211) laid out across space instead of time:
  a filter D× larger than one device's memory at full aggregate
  bandwidth.

All routing is dense and static-shape: per-destination capacity is a
compile-time constant with overflow *detected* (returned as a count, to
be checked on host) rather than silently dropped — a dropped fill would
be a Bloom false-negative, which the algorithm cannot tolerate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from twopaco_tpu.ops import bloom
from twopaco_tpu.passes import kernels

U32 = jnp.uint32
U64 = jnp.uint64
_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # numpy: no backend init at import


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("shard",))


@dataclass(frozen=True)
class ShardedConfig:
    """Pass config + routing capacity for a D-device mesh.

    Ownership is idx mod D (any D, uniform by hash construction); the
    in-shard slot is idx div D.
    """

    base: kernels.PassConfig
    n_devices: int
    slack: float = 1.5

    def __post_init__(self):
        assert (1 << self.base.f) >= 32 * self.n_devices
        assert self.base.B % self.n_devices == 0
        if self.base.layout == "block":
            raise ValueError(
                "the vertex-blocked layout is single-chip only; use "
                "--tpu-layout bit (or byte) with dist-bloom"
            )

    @property
    def local_slots(self) -> int:
        """Bloom slots owned per device (padded to a multiple of 32)."""
        s = -(-(1 << self.base.f) // self.n_devices)
        return ((s + 31) // 32) * 32

    def cap(self, n_slots: int) -> int:
        """Per-destination route capacity for n_slots probes per device."""
        per_dev = n_slots / self.n_devices
        c = int(per_dev * self.slack) + 256
        return min(n_slots, ((c + 127) // 128) * 128)


def make_sharded_filter(mesh: Mesh, scfg: ShardedConfig):
    """Zero-initialized filter sharded by slot ownership across 'shard'."""
    cfg = scfg.base
    if cfg.layout == "byte":
        n = scfg.n_devices * scfg.local_slots
        dtype = jnp.uint8
    else:
        n = scfg.n_devices * (scfg.local_slots // 32)
        dtype = U32
    sharding = NamedSharding(mesh, P("shard"))
    # jit with a sharded out_sharding: each device zero-fills only its
    # own shard — device_put(jnp.zeros(n)) would first materialize the
    # whole (multi-GiB at -f 36+) array on the default device
    return jax.jit(
        lambda: jnp.zeros(n, dtype), out_shardings=sharding
    )()


def _owner_and_slot(idx: jnp.ndarray, scfg: ShardedConfig):
    """Split a global Bloom index into (owner device, local slot)."""
    d = U64(scfg.n_devices)
    owner = (idx % d).astype(jnp.int32)
    local = idx // d
    return owner, local


def _bucket(idx: jnp.ndarray, valid: jnp.ndarray, scfg: ShardedConfig, cap: int):
    """Dense per-owner bucketing of local probe values.

    idx (M,) uint64 global slots, valid (M,) bool ->
      send (D, cap) uint64 (sentinel-padded), order info to un-permute,
      overflow count (int32).
    """
    D = scfg.n_devices
    m = idx.shape[0]
    owner, local = _owner_and_slot(idx, scfg)
    owner = jnp.where(valid, owner, D)  # invalid -> virtual bucket D
    order = jnp.argsort(owner, stable=True)
    o_s = owner[order]
    l_s = local[order]
    counts = jax.ops.segment_sum(
        jnp.ones(m, jnp.int32), o_s, num_segments=D + 1
    )
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    slot = jnp.arange(m, dtype=jnp.int32) - offsets[o_s]
    ok = (slot < cap) & (o_s < D)
    overflow = jnp.sum((slot >= cap) & (o_s < D), dtype=jnp.int32)
    send = jnp.full((D, cap), _SENTINEL, U64)
    # not-ok entries scatter to the out-of-range row D -> dropped
    send = send.at[
        jnp.where(ok, o_s, D), jnp.where(ok, slot, 0)
    ].set(l_s, mode="drop")
    return send, (order, o_s, slot, ok), overflow


def _local_fill(filt_local, recv, layout):
    v = recv != _SENTINEL
    idx = jnp.where(v, recv, U64(0))
    return bloom.fill(filt_local, idx, v, layout)


def _local_probe(filt_local, recv, layout):
    v = recv != _SENTINEL
    idx = jnp.where(v, recv, U64(0))
    return bloom.probe(filt_local, idx, layout) & v


def _unbucket(back: jnp.ndarray, route, m: int):
    order, o_s, slot, ok = route
    got = (
        back[
            jnp.clip(o_s, 0, back.shape[0] - 1),
            jnp.clip(slot, 0, back.shape[1] - 1),
        ]
        & ok
    )
    out = jnp.zeros(m, bool)
    return out.at[order].set(got)


def _fill_shard_fn(filt_local, codes, valid, low, high, *, scfg, cap):
    cfg = scfg.base
    idx, val = kernels.fill_indices(codes, valid, low, high, cfg)
    idx = idx.astype(U64).reshape(-1)
    val = val.reshape(-1)
    send, _route, overflow = _bucket(idx, val, scfg, cap)
    recv = jax.lax.all_to_all(
        send, "shard", split_axis=0, concat_axis=0, tiled=False
    ).reshape(-1)
    filt_local = _local_fill(filt_local, recv, cfg.layout)
    return filt_local, jax.lax.psum(overflow, "shard")


def _mark_shard_fn(filt_local, codes, valid, low, high, *, scfg, cap):
    cfg = scfg.base
    idx, base, prev, nxt = kernels.mark_indices(codes, valid, low, high, cfg)
    shape = idx.shape  # (B/D, P, 8, q)
    idx_f = idx.astype(U64).reshape(-1)
    probe_valid = jnp.broadcast_to(base[:, :, None, None], shape).reshape(-1)
    send, route, overflow = _bucket(idx_f, probe_valid, scfg, cap)
    recv = jax.lax.all_to_all(
        send, "shard", split_axis=0, concat_axis=0, tiled=False
    )
    hits_remote = _local_probe(filt_local, recv.reshape(-1), cfg.layout)
    back = jax.lax.all_to_all(
        hits_remote.reshape(scfg.n_devices, cap),
        "shard",
        split_axis=0,
        concat_axis=0,
        tiled=False,
    )
    hits = _unbucket(back, route, idx_f.shape[0]).reshape(shape)
    # un-probed (invalid) positions read as miss; q-AND over last axis
    hits_q = jnp.all(hits, axis=-1)
    mask = kernels.mark_decide(hits_q, base, prev, nxt)
    return (
        kernels.pack_mask(mask),
        jax.lax.psum(jnp.sum(mask, dtype=jnp.int64), "shard"),
        jax.lax.psum(overflow, "shard"),
    )


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


def sharded_fill_step(mesh: Mesh, scfg: ShardedConfig):
    """Build the jitted sharded fill step: (filt, codes, valid, low, high)
    -> (filt, overflow). Batch rows and filter both sharded on 'shard'."""
    cfg = scfg.base
    n_slots = (cfg.B // scfg.n_devices) * cfg.P * 4 * cfg.q
    cap = scfg.cap(n_slots)
    fn = _shard_map(
        partial(_fill_shard_fn, scfg=scfg, cap=cap),
        mesh,
        in_specs=(P("shard"), P("shard"), P("shard"), P(), P()),
        out_specs=(P("shard"), P()),
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_mark_step(mesh: Mesh, scfg: ShardedConfig):
    """Build the jitted sharded mark step: (filt, codes, valid, low, high)
    -> (mask, count, overflow)."""
    cfg = scfg.base
    n_slots = (cfg.B // scfg.n_devices) * cfg.P * 8 * cfg.q
    cap = scfg.cap(n_slots)
    fn = _shard_map(
        partial(_mark_shard_fn, scfg=scfg, cap=cap),
        mesh,
        in_specs=(P("shard"), P("shard"), P("shard"), P(), P()),
        out_specs=(P("shard"), P(), P()),
    )
    return jax.jit(fn)
