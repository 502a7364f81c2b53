"""End-to-end distributed sort-join engine: FASTA in, .dbg out, over a
device mesh.

This assembles the per-step distributed pieces (parallel/sortshard.py
routing, passes/sortpipe.py record building and judging) into a complete
mesh-aware pipeline with the same contract as the single-device engines
— deterministic, byte-identical output. The reference has no distributed
layer at all (SURVEY.md §2.4); its closest analogue is the -r rounds
mechanism (vertexenumerator.h:176-211), which partitions hash space
across TIME — here the same hash-interval rounds compose with a k-mer
-range partition across SPACE (devices), so a round's records are spread
over D sorts of 1/D the size each.

Dataflow per round:
  1. every batch: build records on the data-parallel rows, gate by the
     round's hash interval (and, in bloom-gate mode, by the sharded
     Bloom filter's candidate marks), route by canonical-k-mer range
     (quantile boundaries measured from the input — GC bias makes a
     uniform word0 split badly skewed) with one all_to_all, and append
     the received records into a per-device resident buffer;
  2. one per-device sort + the FUSED chunked judge/compact
     (sortpipe.judge_compact_fused — every compiled scan step is
     bounded to JUDGE_CHUNK rows, same as the single-device engine);
     all records of a k-mer live on exactly one device, so
     junction decisions are local;
  3. per-(round, device) result blocks are fetched exactly (bucketed
     slices; 4-byte packed occurrences when dense — sortpipe._pack_occ
     applied per device) and fed straight into the engines' shared
     merge tail (sortpipe.merge_fetched): hash intervals x k-mer ranges
     partition the k-mer space, so every (round, device) block is an
     independent dictionary slice.

Positions travel as 1 (narrow) or 2 (wide u32-pair) uint32 columns —
the same scheme as the single-chip engine (sortpipe._pos_base), so
inputs beyond 2^32 positions (~4.2 Gbases; the reference's size_t
positions never cap, vertexenumerator.h:935-958) route and judge
unchanged.

Bloom-gate mode (engine="dist-bloom") is the multi-chip completion of
the reference's own Bloom design (SURVEY.md §2.4: sharded filter fill +
probe with all_to_all routing, parallel/sharded.py) — candidate
positions marked by the hash-sharded filter are then verified and
emitted through the exact same distributed sort-join tail. Every
occurrence of a k-mer receives the same mark decision (the filter holds
all of the k-mer's edges), so the judged candidate records yield output
byte-identical to the ungated engines.

Multi-host note: every collective here is a single mesh all_to_all /
all_gather / psum — under jax.distributed with a mesh spanning hosts
the same program runs unchanged; see parallel/multihost.py for process setup and
per-host input sharding.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from twopaco_tpu.io import fasta as fasta_io
from twopaco_tpu.io import windows
from twopaco_tpu.ops import pack
from twopaco_tpu.parallel.sortshard import SortShardConfig, _route_records
from twopaco_tpu.passes import kernels, sortpipe
from twopaco_tpu.passes.pipeline import (
    PipelineConfig,
    RunStats,
    _input_fingerprint,
    _next_pow2,
    _split_rounds,
)

U32 = jnp.uint32


@dataclass(frozen=True)
class DistConfig:
    """Shapes of the distributed engine (all compile-time static)."""

    base: kernels.PassConfig
    n_devices: int
    dev_slots: int  # per-device record buffer capacity
    route_cap: int  # per (src, dst) all_to_all block rows
    n_pos: int = 1  # position columns: 1 narrow, 2 wide (u32 pair)

    def __post_init__(self):
        assert self.base.B % self.n_devices == 0

    @property
    def n_cols(self) -> int:
        return self.base.w + 1 + self.n_pos


@partial(jax.jit, static_argnames=("cfg", "bin_pow"))
def word0_histogram(codes, valid, *, cfg, bin_pow: int = 16):
    """Histogram of canonical k-mer word0 top bits over one batch — the
    measurement pass behind quantile-balanced routing boundaries."""
    _canonV, _pay, _hv, ok, _flat = sortpipe._batch_records(
        codes, valid, (jnp.uint32(0),), cfg
    )
    top = (_canonV[..., 0] >> (32 - bin_pow)).astype(jnp.int32).reshape(-1)
    okf = ok.reshape(-1)
    return jnp.zeros(1 << bin_pow, jnp.int32).at[
        jnp.where(okf, top, 0)
    ].add(okf.astype(jnp.int32))


def route_bounds_from_hist(
    hist: np.ndarray, n_devices: int, bin_pow: int = 16
) -> np.ndarray:
    """(D-1,) ascending uint32 word0 boundaries of ~equal record mass.

    Bucketing is owner = #{bounds < word0} (searchsorted side='left'),
    so device d owns word0 in (bounds[d-1], bounds[d]]. Ownership is a
    pure function of word0, so all records of one k-mer land on one
    device regardless of where boundaries fall."""
    D = n_devices
    total = int(hist.sum())
    csum = np.cumsum(hist)
    targets = (np.arange(1, D) * total) / D
    bins = np.searchsorted(csum, targets, side="left")
    shift = 32 - bin_pow
    bounds = ((bins + 1) << shift).astype(np.uint64)
    # strictly increasing even on degenerate histograms
    bounds = np.maximum.accumulate(bounds)
    bump = np.arange(D - 1, dtype=np.uint64)
    bounds = np.minimum(bounds + 0, (1 << 32) - (D - 1) + bump)
    for i in range(1, D - 1):
        if bounds[i] <= bounds[i - 1]:
            bounds[i] = bounds[i - 1] + 1
    return bounds.astype(np.uint32)


def _dev_base(base, my_off):
    """Per-device position base: base (host-exact row0*P u32 column
    scalars) + my_off (this device's row offset * P, < 2^32)."""
    if len(base) == 1:
        return (base[0] + my_off,)
    lo = base[1] + my_off
    carry = (lo < my_off).astype(U32)  # u32 wraparound
    return (base[0] + carry, lo)


def _append_fn(
    buf, cnt, codes, valid, mask, base, low, high, bounds, *, dcfg, gated
):
    """shard_map body: one batch -> routed records appended to the local
    per-device buffer. buf (dev_slots, C) uint32, cnt (1,) int32.
    mask: (B/D, P//8) packed candidate bits (bloom-gate mode) or a
    (1,1) dummy when gated=False."""
    cfg = dcfg.base
    D = dcfg.n_devices
    w = cfg.w
    local_rows = cfg.B // D
    my = jax.lax.axis_index("shard")
    my_off = (my * local_rows).astype(jnp.uint32) * U32(cfg.P)
    words, payload, pos = sortpipe.build_sort_records(
        codes, valid, _dev_base(base, my_off), low, high, cfg=cfg
    )
    if gated:
        mk = kernels.unpack_mask(mask, cfg.P).reshape(-1)
        words = jnp.where(mk[:, None], words, sortpipe.SENTINEL_WORD)
        payload = jnp.where(mk, payload, U32(0))
    scfg = SortShardConfig(base=cfg, n_devices=D)
    send, over_route = _route_records(
        words, payload, pos, scfg, dcfg.route_cap, bounds=bounds
    )
    recv = jax.lax.all_to_all(
        send, "shard", split_axis=0, concat_axis=0, tiled=False
    ).reshape(-1, dcfg.n_cols)  # (D*route_cap, C)

    # stable-compact real received records to the block front
    m = recv.shape[0]
    real = ((recv[:, w] >> 17) & U32(1)) > 0
    n_new = jnp.sum(real, dtype=jnp.int32)
    cols = jax.lax.sort(
        ((~real).astype(U32), jnp.arange(m, dtype=U32))
        + tuple(recv[:, i] for i in range(dcfg.n_cols)),
        num_keys=2,
    )
    block = jnp.stack(cols[2:], axis=-1)
    live = jnp.arange(m, dtype=jnp.int32) < n_new
    block = jnp.where(
        live[:, None],
        block,
        jnp.concatenate(
            [
                jnp.full(w, sortpipe.SENTINEL_WORD, U32),
                jnp.zeros(1 + dcfg.n_pos, U32),
            ]
        ),
    )
    # fixed-size block write at the current fill; the sentinel tail is
    # overwritten by the next batch's block (or stays sentinel). An
    # out-of-bounds write would be clamped (corrupting earlier rows) —
    # detected here and raised on host before any result is used.
    over_buf = (cnt[0] + m > dcfg.dev_slots).astype(jnp.int32)
    off = jnp.minimum(cnt[0], jnp.int32(dcfg.dev_slots - m))
    buf = jax.lax.dynamic_update_slice(buf, block, (off, jnp.int32(0)))
    cnt = cnt + n_new
    overflow = jax.lax.psum(over_route + over_buf, "shard")
    return buf, cnt, overflow


def _finish_fn(buf, abundance, *, dcfg, check_abundance, chunk):
    """shard_map body: local sort + fused chunked judge/compact of the
    round's device block. Returns front-packed per-device result
    buffers + per-device counts — local ids stay per-device (each
    (round, device) block is an independent entry of the shared merge,
    sortpipe.merge_fetched)."""
    cfg = dcfg.base
    w = cfg.w
    sw, pay, pos = sortpipe.sort_records(
        buf[:, :w] + U32(0),
        buf[:, w] + U32(0),
        tuple(buf[:, w + 1 + c] + U32(0) for c in range(dcfg.n_pos)),
        w=w,
    )
    tab, op, oi, n_groups, n_junc, n_occ = sortpipe.judge_compact_fused(
        sw, pay, pos, abundance, check_abundance=check_abundance,
        chunk=chunk,
    )
    return (
        tab,
        op,
        oi,
        n_groups[None],
        n_junc[None],
        n_occ[None],
    )


def _pack_fn(op, oi, n_occ_dev, *, exc_cap, delta_bits):
    """shard_map body: per-device 4-byte occurrence packing (see
    sortpipe._pack_occ). n_occ_dev: (1,) int64 per device."""
    packed, exc_i, exc_hi, exc_lo, n_exc = sortpipe._pack_occ(
        op, oi, n_occ_dev[0].astype(jnp.uint32),
        exc_cap=exc_cap, delta_bits=delta_bits,
    )
    return packed, exc_i, exc_hi, exc_lo, n_exc[None]


def _make_steps(
    mesh: Mesh, dcfg: DistConfig, check_abundance: bool, chunk: int,
    gated: bool,
):
    C = dcfg.n_cols
    shard = NamedSharding(mesh, P("shard"))
    repl = NamedSharding(mesh, P())
    n_base = dcfg.n_pos

    @partial(jax.jit, out_shardings=(shard, shard))
    def init_bufs():
        buf = jnp.full(
            (dcfg.n_devices * dcfg.dev_slots, C), sortpipe.SENTINEL_WORD,
            U32,
        )
        buf = buf.at[:, dcfg.base.w :].set(U32(0))  # payload/pos lanes
        cnt = jnp.zeros(dcfg.n_devices, jnp.int32)
        return buf, cnt

    append = jax.jit(
        jax.shard_map(
            partial(_append_fn, dcfg=dcfg, gated=gated),
            mesh=mesh,
            in_specs=(
                P("shard"), P("shard"), P("shard"), P("shard"),
                P("shard"), (P(),) * n_base, P(), P(), P(),
            ),
            out_specs=(P("shard"), P("shard"), P()),
        ),
        donate_argnums=(0, 1),
        in_shardings=(
            shard, shard, shard, shard, shard,
            (repl,) * n_base, repl, repl, repl,
        ),
    )
    finish = jax.jit(
        jax.shard_map(
            partial(
                _finish_fn, dcfg=dcfg, check_abundance=check_abundance,
                chunk=chunk,
            ),
            mesh=mesh,
            in_specs=(P("shard"), P()),
            out_specs=(
                P("shard"),
                (P("shard"),) * dcfg.n_pos,
                P("shard"),
                P("shard"), P("shard"), P("shard"),
            ),
            # the fused judge's lax.scan carries constant-initialized
            # buffers; the vma checker rejects unvarying carry inits
            # (outputs ARE per-device varying, as declared above)
            check_vma=False,
        ),
        donate_argnums=(0,),
    )

    def make_pack(exc_cap: int, delta_bits: int):
        return jax.jit(
            jax.shard_map(
                partial(
                    _pack_fn, exc_cap=exc_cap, delta_bits=delta_bits
                ),
                mesh=mesh,
                in_specs=(
                    (P("shard"),) * dcfg.n_pos, P("shard"), P("shard"),
                ),
                out_specs=(
                    P("shard"), P("shard"), P("shard"), P("shard"),
                    P("shard"),
                ),
                check_vma=False,
            ),
        )

    return init_bufs, append, finish, make_pack


def build_junctions_dist(
    input_paths: Sequence[str] | None,
    config: PipelineConfig,
    mesh: Mesh | None = None,
    out_path: str | None = None,
    sequences: Sequence[tuple[int, np.ndarray]] | None = None,
    log: Callable[[str], None] = lambda s: None,
    checkpoint_dir: str | None = None,
    bloom_gate: bool = False,
):
    """Mesh-parallel counterpart of sortpipe.build_junctions_sorted
    (same contract, byte-identical output). bloom_gate=True runs the
    reference's Bloom candidate pass on the hash-sharded filter first
    and routes only marked positions (engine="dist-bloom")."""
    from twopaco_tpu.parallel.sharded import (
        ShardedConfig,
        make_mesh,
        make_sharded_filter,
        sharded_fill_step,
        sharded_mark_step,
    )

    if mesh is None:
        mesh = make_mesh()
    D = mesh.devices.size
    # only dist-bloom allocates a filter, and it is sharded: resolve
    # the layout against the PER-DEVICE slot count so -f 36..40 work
    # once the mesh is wide enough (reference README.md:71-79 sizes)
    cfg = config.pass_config(
        filterless=not bloom_gate, shard_devices=D if bloom_gate else 1
    )
    if cfg.B % D:
        raise ValueError(
            f"rows_per_batch ({cfg.B}) must be a multiple of the mesh "
            f"size ({D})"
        )
    wcfg = config.window_config()
    stats = RunStats()
    t_start = time.time()

    if sequences is None:
        sequences = [
            (sid, codes)
            for sid, _hdr, codes in fasta_io.read_all_records(input_paths)
        ]
    batches = list(windows.iter_window_batches(iter(sequences), wcfg))
    stats.total_positions = sum(int(b.valid.sum()) for b in batches)
    n_slots = len(batches) * cfg.B * cfg.P
    # beyond 2^32 flat positions (~4.2 Gbases) records carry a second
    # u32 position column, exactly as the single-chip engine
    wide = (
        n_slots >= 1 << 32
        or config.force_wide
        or os.environ.get("TWOPACO_POS64") == "1"
    )
    n_pos = 2 if wide else 1
    log(
        f"Engine = distributed {'bloom-gated ' if bloom_gate else ''}"
        f"sort-join over {D} devices\n"
        f"Vertex length = {config.k}\nRecord slots = {n_slots}"
    )

    from twopaco_tpu.parallel import multihost

    put = multihost.make_put(mesh)
    # all host reads of device results go through multihost.fetch: a
    # plain np.asarray on a cross-process P("shard") array raises (the
    # local process holds only its own rows); fetch() all-gathers those
    # and passes replicated/local arrays straight through
    F = multihost.fetch
    dev_batches = [
        (
            tuple(put(a) for a in pack.pack_codes_host(b.codes)),
            put(b.valid),
            b.row0,
        )
        for b in batches
    ]

    # measurement passes: round intervals (vertex-hash mass) + routing
    # boundaries (canonical word0 mass)
    bin_pow = 16
    # auto-rounds: cap the per-device sort at sort_chunk records (the
    # single-chip engine's knob, derated by round_slack for hash-mass
    # imbalance across intervals)
    capacity = max(1, int(config.sort_chunk * D / config.round_slack))
    n_rounds = max(config.rounds, -(-n_slots // capacity))
    whist = None
    hist = None
    for codes_d, valid_d, _r0 in dev_batches:
        wh = word0_histogram(codes_d, valid_d, cfg=cfg, bin_pow=bin_pow)
        whist = wh if whist is None else whist + wh
        if n_rounds > 1:
            h = kernels.histogram_vertex_hashes(
                codes_d, valid_d, cfg=cfg, bin_pow=bin_pow
            )
            hist = h if hist is None else hist + h
    bounds = route_bounds_from_hist(F(whist), D, bin_pow)
    # host numpy (not jnp.asarray): numpy inputs are treated as
    # replicated process-identical values under multi-process jit; a
    # committed local-device array would not be
    bounds_d = bounds
    intervals = (
        _split_rounds(F(hist), n_rounds, bin_pow)
        if n_rounds > 1
        else [(0, 0xFFFFFFFF)]
    )
    if len(intervals) > 1:
        log(f"Splitting the input kmers set ({len(intervals)} rounds)")

    # capacities: per-batch route blocks + per-round device buffers,
    # derated by round_slack for residual imbalance (overflow detected)
    per_batch_dev = (cfg.B // D) * cfg.P
    route_cap = min(
        per_batch_dev,
        ((int(per_batch_dev / D * config.round_slack) + 256 + 127) // 128)
        * 128,
    )
    block = D * route_cap
    exp_round_dev = n_slots / len(intervals) / D
    dev_slots = int(exp_round_dev * config.round_slack) + block
    # the fused judge scans the buffer in `chunk`-row steps: pad the
    # buffer to a whole number of chunks
    if dev_slots > sortpipe.JUDGE_CHUNK:
        dev_slots = (
            -(-dev_slots // sortpipe.JUDGE_CHUNK) * sortpipe.JUDGE_CHUNK
        )
    chunk = min(sortpipe.JUDGE_CHUNK, dev_slots)
    dcfg = DistConfig(
        base=cfg, n_devices=D, dev_slots=dev_slots, route_cap=route_cap,
        n_pos=n_pos,
    )
    check_ab = config.abundance < (1 << 64) - 1
    abundance_d = np.uint64(config.abundance)
    init_bufs, append, finish, make_pack = _make_steps(
        mesh, dcfg, check_ab, chunk, bloom_gate
    )
    m_buf = dev_slots + chunk  # per-device rows of the finish buffers
    # statically-safe per-device exception capacity for the 4-byte
    # packed fetch (deltas per device sum to <= max position)
    occ_exc_cap = _next_pow2(
        max((n_slots >> sortpipe._OCC_MIN_DELTA_BITS) + 2, 16)
    )
    dummy_mask = None
    fill_step = mark_step = scfg_bloom = None
    if bloom_gate:
        scfg_bloom = ShardedConfig(base=cfg, n_devices=D)
        fill_step = sharded_fill_step(mesh, scfg_bloom)
        mark_step = sharded_mark_step(mesh, scfg_bloom)
    else:
        dummy_mask = put(
            np.zeros((cfg.B, cfg.P // 8), np.uint8)
        )

    # checkpoint/resume at round boundaries — shared format with the
    # single-chip sort engine (entries are engine-independent data)
    fingerprint = None
    if checkpoint_dir is not None:
        fingerprint = _input_fingerprint(input_paths, sequences)
    # multi-process: the writer owns meta.json + stale-round wiping;
    # everyone else opens read-only after a barrier (shared fs)
    if multihost.is_writer():
        ckpt = sortpipe._Checkpoint(
            checkpoint_dir, config, n_slots, intervals, fingerprint
        )
        multihost.barrier("ckpt_init")
    else:
        multihost.barrier("ckpt_init")
        ckpt = sortpipe._Checkpoint(
            checkpoint_dir, config, n_slots, intervals, fingerprint,
            read_only=True,
        )

    fetched: list = []  # (table, kind, payload) entries for the merge
    for r, (low, high) in enumerate(intervals):
        restored = ckpt.load_round(r)
        if restored is not None:
            entry, rstats = restored
            fetched.append(entry)
            stats.rounds.append(rstats)
            log(f"Round {r}: restored from checkpoint")
            continue
        log(f"Round {r}, {low}:{high}")
        t0 = time.time()
        low_d, high_d = np.uint32(low), np.uint32(high)
        marks = 0
        if bloom_gate:
            filt = make_sharded_filter(mesh, scfg_bloom)
            overflow = 0
            for codes_d, valid_d, _r0 in dev_batches:
                filt, over = fill_step(
                    filt, codes_d, valid_d, low_d, high_d
                )
                overflow += int(over)
            if overflow:
                raise RuntimeError(
                    f"sharded Bloom fill route overflow ({overflow}) — "
                    "raise ShardedConfig.slack"
                )
        buf, cnt = init_bufs()
        overflow = 0
        for codes_d, valid_d, row0 in dev_batches:
            if bloom_gate:
                mask_d, mcount, over = mark_step(
                    filt, codes_d, valid_d, low_d, high_d
                )
                overflow += int(over)
                marks += int(mcount)
            else:
                mask_d = dummy_mask
            buf, cnt, over = append(
                buf, cnt, codes_d, valid_d, mask_d,
                sortpipe._pos_base(row0, cfg.P, wide),
                low_d, high_d, bounds_d,
            )
            overflow += int(over)
        if bloom_gate:
            del filt
        if overflow:
            raise RuntimeError(
                f"distributed record buffer overflow ({overflow} "
                "routing/append drops) — raise PipelineConfig."
                "round_slack or rounds"
            )
        t_build = time.time() - t0

        t0 = time.time()
        tab_g, op_g, oi_g, ngroups_d, njunc_d, nocc_d = finish(
            buf, abundance_d
        )
        njunc = F(njunc_d)  # (D,) — forces the round
        nocc = F(nocc_d)
        ngroups = F(ngroups_d)
        n_junc, n_occ = int(njunc.sum()), int(nocc.sum())

        # 4-byte packed fetch when every device's block is dense enough
        # (shared static delta_bits: lids must fit the largest table)
        spec = (
            sortpipe._occ_pack_spec(
                int(njunc.max()), int(nocc.min()), n_slots
            )
            if n_occ > 0 and int(nocc.min()) > 0
            else None
        )
        round_entries = []
        if spec is not None:
            pack_step = make_pack(occ_exc_cap, spec)
            packed_g, exci_g, exch_g, excl_g, nexc_d = pack_step(
                op_g, oi_g, nocc_d
            )
            nexc = F(nexc_d)
            for d in range(D):
                cap_t = sortpipe._fetch_cap(int(njunc[d]), m_buf)
                cap_o = sortpipe._fetch_cap(int(nocc[d]), m_buf)
                ecf = sortpipe._fetch_cap(
                    max(int(nexc[d]), 1), occ_exc_cap
                )
                t_off, e_off = d * m_buf, d * occ_exc_cap
                round_entries.append(
                    sortpipe._fetch_round_packed(
                        F(tab_g[t_off : t_off + cap_t]),
                        F(packed_g[t_off : t_off + cap_o]),
                        F(exci_g[e_off : e_off + ecf]),
                        F(exch_g[e_off : e_off + ecf]),
                        F(excl_g[e_off : e_off + ecf]),
                        int(njunc[d]), int(nocc[d]), spec,
                    )
                )
        else:
            for d in range(D):
                cap_t = sortpipe._fetch_cap(int(njunc[d]), m_buf)
                cap_o = sortpipe._fetch_cap(int(nocc[d]), m_buf)
                t_off = d * m_buf
                round_entries.append(
                    sortpipe._fetch_round_exact(
                        F(tab_g[t_off : t_off + cap_t]),
                        tuple(
                            F(c[t_off : t_off + cap_o]) for c in op_g
                        ),
                        F(oi_g[t_off : t_off + cap_o]),
                        int(njunc[d]), int(nocc[d]),
                    )
                )
        del tab_g, op_g, oi_g
        t_finish = time.time() - t0
        stats.rounds.append(
            dict(
                low=low,
                high=high,
                marks=marks if bloom_gate else n_occ,
                hash_table_size=int(ngroups.sum()),
                true_junctions=n_junc,
                false_positives=0,
                t_build=t_build,
                t_finish=t_finish,
            )
        )
        log(
            f"Routed+appended\t{t_build:.1f}\nSort+judge\t{t_finish:.1f}\n"
            f"True junctions = {n_junc}\nOccurrences = {n_occ}"
        )
        if checkpoint_dir is not None:
            # one self-consistent raw entry per round: concatenate the
            # device blocks (device-major = the round's global k-mer
            # order) and offset local ids by the running table length
            tabs = [t for t, _, _ in round_entries]
            occ_parts, id_parts = [], []
            t_off = 0
            for tab, kind, payload in round_entries:
                pos_d, oi_d = sortpipe._round_raw_occ(kind, payload)
                gid = oi_d + np.sign(oi_d) * t_off
                occ_parts.append(pos_d)
                id_parts.append(gid)
                t_off += len(tab)
            entry = (
                np.concatenate(tabs) if tabs else
                np.zeros((0, cfg.w), np.uint32),
                "raw",
                (
                    (np.concatenate(occ_parts) if occ_parts
                     else np.zeros(0, np.int64),),
                    np.concatenate(id_parts) if id_parts
                    else np.zeros(0, np.int64),
                ),
            )
            # multi-process: single-writer checkpoints (shared fs),
            # barrier so no process resumes past a round whose file
            # isn't durable yet
            if multihost.is_writer():
                ckpt.save_round(r, entry, stats.rounds[-1])
            multihost.barrier(f"ckpt_round_{r}")
            fetched.append(entry)
        else:
            fetched.extend(round_entries)

    del dev_batches
    return sortpipe.merge_fetched(
        fetched, batches, cfg, config, out_path, stats, log, t_start,
        n_slots=n_slots, wide=wide, n_sequences=len(sequences),
    )
