"""Sort-join junction engine: the default pipeline.

The reference's Bloom-filter two-pass design exists because a 2005-era
CPU cannot hold or sort all k-mers: random single-bit probes are its
cheapest primitive (SURVEY.md §0). On an accelerator the cost model
inverts: a device sort streams multi-word records at memory bandwidth,
while random gathers and scatters over device memory are the expensive
primitive. So this engine is a sort-join:

  1. per window batch, build one record per vertex position:
       (canonical k-mer words, packed {in, out, is_rc}, flat position)
     — O(1)/position, fully vectorized (ops/pack);
  2. one device sort of the round's records by the w k-mer words;
  3. segmented reduction marks junction groups (distinct-extension rule,
     identical semantics to the reference hash-table merge,
     vertexenumerator.h:778-796 — and to kernels.verify_records);
  4. junction ids fall out of the SAME sort: rank among junction groups
     in k-mer order == the sorted-dictionary rank the Bloom path
     computes with binary searches;
  5. occurrences (position, ±id) are compacted and re-sorted by
     position; stubs are assigned on the host exactly as in the Bloom
     path.

Exactness: no Bloom false positives, no verification pass, no filter
memory. Multi-round mode partitions the record set by the symmetric
vertex hash to bound the sort working set (the reference's -r semantics
across time; rounds' junction tables are merged and local ids remapped
to global ranks at the end).
"""

from __future__ import annotations

import math
import os
import time
from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from twopaco_tpu import dna
from twopaco_tpu.hostmem import big_empty
from twopaco_tpu.io import fasta as fasta_io
from twopaco_tpu.io import junctions as junction_io
from twopaco_tpu.io import windows
from twopaco_tpu.ops import buzhash as bz
from twopaco_tpu.ops import pack
from twopaco_tpu.passes import kernels
from twopaco_tpu.passes.pipeline import (
    Enumerator,
    PipelineConfig,
    RoundCheckpoint,
    RunStats,
    STUB_ID_OFFSET,
    _bucket_cap,
    _input_fingerprint,
    _next_pow2,
    _split_rounds,
    emit_junctions,
    emit_junctions_packed,
)

U32 = jnp.uint32
SENTINEL_WORD = np.uint32(0xFFFFFFFF)  # numpy: no backend init at import


# ---- positions -------------------------------------------------------
#
# Flat positions (global_row * P + col) travel as a TUPLE of uint32
# columns: ("lo",) for inputs under 2^32 positions, ("hi", "lo") beyond
# (the reference's size_t positions, vertexenumerator.h:935-958, have
# no 4.2 Gbase cliff; wide positions are a carry-propagated u32 pair, so
# inputs under 2^32 positions sort and move one 4-byte column instead of
# an 8-byte one). The tuple length keys the jit trace, so small inputs
# keep their exact current programs/compile cache.


def _pos_base(row0: int, P: int, wide: bool):
    """Host-exact base = row0 * P as a tuple of u32 device scalars."""
    base = int(row0) * int(P)
    if wide:
        return (jnp.uint32(base >> 32), jnp.uint32(base & 0xFFFFFFFF))
    return (jnp.uint32(base & 0xFFFFFFFF),)


def _host_pos(pos_comps) -> np.ndarray:
    """Combine fetched position column(s) into one int64 array."""
    comps = [np.asarray(c) for c in pos_comps]
    if len(comps) == 1:
        return comps[0].astype(np.int64)
    hi, lo = comps
    return (hi.astype(np.int64) << 32) | lo.astype(np.int64)

# Device byte budget for resident-parts mode (records kept on device
# across rounds instead of rebuilt per round): 3/8 of what the device
# lets the process allocate, because the round's sort needs ~2x its
# buffer on top of the parts. A backend that reports no limit (the CPU)
# gets 6 GiB. TWOPACO_RESIDENT_BYTES overrides it.
_RESIDENT_SHARE = 3 / 8
_RESIDENT_DEFAULT = 6 << 30


def resident_budget(bytes_limit: int | None) -> int:
    """Resident-parts byte budget for a device that may allocate
    `bytes_limit` bytes (None: unknown)."""
    if not bytes_limit:
        return _RESIDENT_DEFAULT
    return int(bytes_limit * _RESIDENT_SHARE)


def _resident_bytes() -> int:
    env = os.environ.get("TWOPACO_RESIDENT_BYTES")
    if env:
        return int(env)
    stats = jax.devices()[0].memory_stats() or {}
    return resident_budget(stats.get("bytes_limit"))


def _batch_records(codes, valid, base, cfg):
    """Record columns for every vertex position of one batch (ungated):
    (canonical words (B,P,w), payload u32 in|out<<8|is_rc<<16, symmetric
    vertex hash hv (B,P), validity ok (B,P), flat position — a tuple of
    1 or 2 (B,P) u32 columns, see _pos_base). base = row0*P as u32
    scalar(s)."""
    k, P = cfg.k, cfg.P
    codes = pack.as_codes(codes, P + k + 1)
    B = codes.shape[0]  # may be cfg.B / n_devices under shard_map
    words_all, rc_all, def_all = kernels._strand_arrays(codes, cfg)
    V = words_all[:, 1 : P + 1]
    rcV = rc_all[:, 1 : P + 1]
    defV = def_all[:, 1 : P + 1]
    prev = codes[:, 0:P]
    nxt = codes[:, k + 1 : k + 1 + P]
    canonV, is_rc = pack.canonical(V, rcV)

    hf, hr = bz.window_hashes(
        *bz.hash_scans(codes, bz.TABLE_1), k, P + 1
    )
    hv = hf[:, 1 : P + 1] + hr[:, 1 : P + 1]
    ok = kernels._pos_ok(valid, P) & defV

    in_code = jnp.where(is_rc, kernels._comp4(nxt), prev).astype(U32)
    out_code = jnp.where(is_rc, kernels._comp4(prev), nxt).astype(U32)
    payload = in_code | (out_code << 8) | (is_rc.astype(U32) << 16)
    # in-batch offset < B*P (~2M) always fits u32
    off = (
        jnp.arange(B, dtype=jnp.uint32)[:, None] * U32(P)
        + jnp.arange(P, dtype=jnp.uint32)[None, :]
    )
    if len(base) == 1:
        flat = (base[0] + off,)
    else:
        lo = base[1] + off
        carry = (lo < base[1]).astype(U32)  # u32 wraparound
        flat = (base[0] + carry, lo)
    return canonV, payload, hv, ok, flat


@partial(jax.jit, static_argnames=("cfg",))
def build_sort_records(codes, valid, base, low, high_incl, *, cfg):
    """One record per vertex position of the batch.

    -> (words (B*P, w) canonical, payload (B*P,) u32 = in | out<<8 |
    is_rc<<16 | real<<17, pos: tuple of 1-2 (B*P,) u32 global flat
    position columns). base = _pos_base(row0, P, wide). Invalid /
    non-definite / out-of-round rows become all-ones sentinels that sort
    to the end.
    """
    codes = pack.as_codes(codes, cfg.P + cfg.k + 1)
    B, P = codes.shape[0], cfg.P
    canonV, payload, hv, ok, flat = _batch_records(codes, valid, base, cfg)
    ok = ok & kernels._within(hv, low, high_incl)
    words = jnp.where(ok[..., None], canonV, SENTINEL_WORD)
    payload = jnp.where(ok, payload | (U32(1) << 17), U32(0))
    return (
        words.reshape(B * P, cfg.w),
        payload.reshape(-1),
        tuple(f.reshape(-1) for f in flat),
    )


@partial(jax.jit, static_argnames=("cfg", "n_parts", "part_cap"))
def build_and_partition(
    codes, valid, base, highs, low, high_incl, *, cfg, n_parts, part_cap
):
    """Build one batch's records and split them by round in ONE fused
    program: the resident-parts engine builds records once per run
    instead of once per round (the stream engine's re-build is the
    analogue of the reference re-streaming FASTA every round,
    vertexenumerator.h:228-392 — here the partition replaces it).

    Round of a record = interval index of its symmetric vertex hash
    (highs = non-decreasing inclusive interval upper bounds; records
    outside [low, high_incl] are dropped — the full hash range for the
    resident engine, one group's range for the grouped engine). Returns
    fixed shapes regardless of data: (words (n_parts, part_cap, w),
    payload (n_parts, part_cap), pos (n_parts, part_cap), counts
    (n_parts,)). counts[r] > part_cap means the fixed cap overflowed
    (records beyond it were dropped) — the caller MUST check and
    re-partition.
    """
    codes = pack.as_codes(codes, cfg.P + cfg.k + 1)
    B, P, w = codes.shape[0], cfg.P, cfg.w
    m = B * P
    canonV, payload, hv, ok, _flat = _batch_records(codes, valid, base, cfg)
    ok = ok & kernels._within(hv, low, high_incl)
    okf = ok.reshape(-1)
    part = jnp.searchsorted(highs, hv.reshape(-1), side="left").astype(U32)
    part = jnp.where(okf, part, U32(n_parts))  # invalid -> own tail part

    # sort ONLY (part, iota) — 2 columns instead of 1+w+1+np — then
    # gather the record columns for the <= n_parts*cap surviving rows;
    # the stable sort keeps rows of one part in input order exactly as
    # a sort of all the columns would, so downstream bytes are
    # unchanged. Block positions are the IN-BATCH offset
    # (iota < B*P) — assemble_round adds the batch base back, which
    # drops the second (carry) position column from the blocks at
    # >4.2 Gbase scale: 20 -> 16 B/slot of resident-block HBM.
    iota = jnp.arange(m, dtype=jnp.int32)
    partS, idxS = jax.lax.sort((part, iota), num_keys=1)
    counts = jnp.sum(
        partS[None, :] == jnp.arange(n_parts, dtype=U32)[:, None],
        axis=1,
        dtype=jnp.int32,
    )
    starts = jnp.cumsum(counts) - counts

    wordsf = canonV.reshape(m, w)
    payf = payload.reshape(-1)
    # pad so every fixed-size slice below is in bounds (start <= m)
    idxS = jnp.concatenate([idxS, jnp.zeros(part_cap, jnp.int32)])
    live_i = jnp.arange(part_cap, dtype=jnp.int32)
    out_w, out_pay, out_off = [], [], []
    for r in range(n_parts):
        live = live_i < counts[r]
        sl = jax.lax.dynamic_slice(idxS, (starts[r],), (part_cap,))
        out_w.append(
            jnp.where(live[:, None], wordsf[sl], SENTINEL_WORD)
        )
        out_pay.append(
            jnp.where(live, payf[sl] | (U32(1) << 17), U32(0))
        )
        out_off.append(jnp.where(live, sl.astype(U32), U32(0)))
    return (
        jnp.stack(out_w),
        jnp.stack(out_pay),
        (jnp.stack(out_off),),
        counts,
    )


@partial(jax.jit, static_argnames=("buf_slots",))
def assemble_round(r, parts_w, parts_pay, parts_pos, base_st, *, buf_slots):
    """Slice round r's fixed-cap part blocks (stacked (nb, n_parts,
    cap, ...) from _partition_scan) into one sentinel-padded sort
    buffer (a single program for all rounds).

    Block positions are in-batch offsets (build_and_partition stores
    iota < B*P); the global flat position is rebuilt here from base_st
    (tuple of (nb,) u32 columns, wide = (hi, lo)) — the blocks
    themselves never carry the second position column."""
    nb = parts_w.shape[0]
    cap = parts_w.shape[2]
    ws = jax.lax.dynamic_index_in_dim(
        parts_w, r, axis=1, keepdims=False
    ).reshape(-1, parts_w.shape[-1])
    pays = jax.lax.dynamic_index_in_dim(
        parts_pay, r, axis=1, keepdims=False
    ).reshape(-1)
    off = jax.lax.dynamic_index_in_dim(
        parts_pos[0], r, axis=1, keepdims=False
    )  # (nb, cap)
    if len(base_st) == 1:
        poss = ((base_st[0][:, None] + off).reshape(-1),)
    else:
        hi, lo_b = base_st
        lo = lo_b[:, None] + off
        carry = (lo < lo_b[:, None]).astype(U32)  # u32 wraparound
        poss = (
            (hi[:, None] + carry).reshape(-1),
            lo.reshape(-1),
        )
    del nb, cap
    pad = buf_slots - ws.shape[0]
    if pad:
        ws = jnp.concatenate(
            [ws, jnp.full((pad, ws.shape[1]), SENTINEL_WORD, U32)]
        )
        pays = jnp.concatenate([pays, jnp.zeros(pad, U32)])
        poss = tuple(
            jnp.concatenate([p, jnp.zeros(pad, U32)]) for p in poss
        )
    return ws, pays, poss


@partial(jax.jit, static_argnames=("cfg", "bin_pow", "stride"))
def _histogram_scan(codes_st, valid_st, *, cfg, bin_pow: int = 16, stride: int = 1):
    """Vertex-hash histogram over ALL stacked batches in one program
    (one dispatch instead of one per batch).

    stride > 1 subsamples positions (hash values are pseudorandom, so
    a strided sample is unbiased), so the histogram's scatter-add
    touches a bounded number of elements at any input size. The split
    only needs per-interval mass to ~1%, and both consumers
    re-check real counts (resident partition re-splits on overflow;
    the stream path raises)."""

    def step(acc, xs):
        codes, valid = xs
        h = kernels.histogram_vertex_hashes(
            codes, valid, cfg=cfg, bin_pow=bin_pow, stride=stride
        )
        return acc + h, None

    init = jnp.zeros(1 << bin_pow, jnp.int32)
    acc, _ = jax.lax.scan(step, init, (codes_st, valid_st))
    return acc


@partial(jax.jit, static_argnames=("cfg", "n_parts", "part_cap"))
def _partition_scan(
    codes_st, valid_st, base_st, highs, low, high_incl, *,
    cfg, n_parts, part_cap,
):
    """build_and_partition over all stacked batches in one program.
    Returns stacked (nb, n_parts, part_cap, w) words, (nb, n_parts,
    part_cap) payload, tuple of position columns, (nb, n_parts) counts."""

    def step(_, xs):
        codes, valid, base = xs
        return None, build_and_partition(
            codes, valid, base, highs, low, high_incl,
            cfg=cfg, n_parts=n_parts, part_cap=part_cap,
        )

    _, ys = jax.lax.scan(step, None, (codes_st, valid_st, base_st))
    return ys


@partial(jax.jit, donate_argnums=(0, 1, 2))
def append_records(buf_w, buf_pay, buf_pos, words, payload, pos, offset):
    zero = jnp.int32(0)
    buf_w = jax.lax.dynamic_update_slice(buf_w, words, (offset, zero))
    buf_pay = jax.lax.dynamic_update_slice(buf_pay, payload, (offset,))
    buf_pos = tuple(
        jax.lax.dynamic_update_slice(b, p, (offset,))
        for b, p in zip(buf_pos, pos)
    )
    return buf_w, buf_pay, buf_pos


@partial(jax.jit, static_argnames=("cap",))
def compact_batch_records(words, payload, pos, *, cap: int):
    """Keep only real (in-round) records of a batch, sentinel-padded to
    the bucketed cap: one stable 2-key sort, no scatter.
    -> (words (cap, w), payload (cap,), pos (cap,), count)."""
    m = words.shape[0]
    real = ((payload >> 17) & U32(1)) > 0
    count = jnp.sum(real, dtype=jnp.int32)
    flag = (~real).astype(U32)
    idx = jnp.arange(m, dtype=U32)
    cols = jax.lax.sort(
        (flag, idx)
        + tuple(words[:, i] for i in range(words.shape[1]))
        + (payload,)
        + pos,
        num_keys=2,
    )
    w = words.shape[1]
    out_w = jnp.stack(cols[2 : 2 + w], axis=-1)[:cap]
    out_pay = cols[2 + w][:cap]
    out_pos = tuple(c[:cap] for c in cols[3 + w :])
    live = jnp.arange(cap) < count
    out_w = jnp.where(live[:, None], out_w, SENTINEL_WORD)
    out_pay = jnp.where(live, out_pay, U32(0))
    return out_w, out_pay, out_pos, count


@partial(jax.jit, static_argnames=("w",), donate_argnums=(0, 1, 2))
def sort_records(buf_w, buf_pay, buf_pos, *, w: int):
    """Sort records by the w k-mer words (payload + pos carried along).
    buf_pos is a tuple of 1-2 position columns."""
    cols = tuple(buf_w[:, i] for i in range(w)) + (buf_pay,) + buf_pos
    sorted_cols = jax.lax.sort(cols, num_keys=w)
    sw = jnp.stack(sorted_cols[:w], axis=-1)
    return sw, sorted_cols[w], tuple(sorted_cols[w + 1 :])


@partial(jax.jit, static_argnames=("check_abundance",))
def judge_records(sw, pay, abundance, *, check_abundance: bool):
    """Mark junction groups over k-mer-sorted records; assign local ids.

    Scatter-free and scan-lean: the 8 distinct-extension indicators live
    as bits of one uint32 OR-scanned per group (popcount -> distinct
    counts), plus one sum-scan for the two N-extension counters (and one
    for group size when an abundance threshold is active).

    Returns (keep_first, keep, ids, n_groups, n_junc, n_occ).
    """
    from twopaco_tpu.ops import segments as sg

    prev_w = jnp.concatenate([~sw[:1], sw[:-1]])
    new_group = jnp.any(sw != prev_w, axis=-1)

    in_code = pay & U32(0xFF)
    out_code = (pay >> 8) & U32(0xFF)
    is_rc = ((pay >> 16) & U32(1)) > 0
    real = ((pay >> 17) & U32(1)) > 0  # sentinels form their own group

    in_acgt = jnp.minimum(in_code, 4)
    out_acgt = jnp.minimum(out_code, 4)
    ext_bits = jnp.where(in_acgt < 4, U32(1) << in_acgt, U32(0)) | jnp.where(
        out_acgt < 4, U32(1) << (out_acgt + 8), U32(0)
    )
    group_bits = sg.seg_reduce_broadcast(ext_bits, new_group, jnp.bitwise_or)

    def popcount4(x):
        return (
            (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)
        ).astype(jnp.int32)

    n_counts = (in_code == 4).astype(U32) | (
        ((out_code == 4).astype(U32)) << 16
    )
    n_scan = sg.seg_reduce_broadcast(n_counts, new_group, sg._satadd_u16x2)
    n_in = (n_scan & U32(0xFFFF)).astype(jnp.int32)
    n_out = (n_scan >> 16).astype(jnp.int32)
    indeg = popcount4(group_bits & U32(0xF)) + n_in
    outdeg = popcount4((group_bits >> 8) & U32(0xF)) + n_out
    keep = ((indeg > 1) | (outdeg > 1)) & real
    if check_abundance:
        size = sg.seg_sum(jnp.ones(sw.shape[0], jnp.int32), new_group)
        keep = keep & (size.astype(jnp.uint64) <= abundance)
    keep_first = new_group & keep

    # rank among kept groups: cumsum of keep_first is constant within a
    # group after its first record, so it IS the per-record group rank
    rank = jnp.cumsum(keep_first.astype(jnp.int32))
    ids = jnp.where(keep, jnp.where(is_rc, -rank, rank), 0)
    n_groups = jnp.sum(new_group & real, dtype=jnp.int64)
    n_junc = jnp.sum(keep_first, dtype=jnp.int64)
    n_occ = jnp.sum(keep, dtype=jnp.int64)
    return keep_first, keep, ids, n_groups, n_junc, n_occ



# --- chunked judge + compaction: every compiled scan step is bounded to
# JUDGE_CHUNK rows, so record counts scale without the compiled program
# growing with them. Semantics identical to judge_records (tested
# byte-identical).

JUDGE_CHUNK = 1 << 20


def _bucket_slots(m: int) -> int:
    """Bucketed sort-buffer size >= m: pow2 below JUDGE_CHUNK, a
    multiple of JUDGE_CHUNK above. Bounds the set of compiled program
    shapes across arbitrary input sizes (single-round path)."""
    if m >= JUDGE_CHUNK:
        return -(-m // JUDGE_CHUNK) * JUDGE_CHUNK
    return 1 << max(14, (m - 1).bit_length())


_JUDGE_OPS = ("or", "satadd_u16x2", "add")


@partial(
    jax.jit,
    static_argnames=("check_abundance", "chunk"),
    donate_argnums=(0, 1, 2),
)
def judge_compact_fused(sw, pay, pos, abundance, *, check_abundance, chunk):
    """Whole-round judge + compaction as ONE dispatched program.

    Semantics identical to judge_records followed by compacting the
    junction-first rows / occurrence rows (engine-level byte-identity
    is covered by test_engines_agree and the golden/differential
    suites), but chunked as lax.scan steps — per-round host interaction drops
    from ~60 dispatches + whole-buffer fetches to one dispatch +
    exact-slice fetches. Per-step footprint stays at `chunk` rows, so
    the compiled program does not grow with the round.

    Returns (table_buf (m+chunk, w) junction k-mers packed at the
    front, occ_pos_buf, occ_id_buf (m+chunk,) occurrence records packed
    at the front in k-mer order, n_groups, n_junc, n_occ).
    """
    from twopaco_tpu.ops import segments as sg

    m, w = sw.shape
    n_chunks = m // chunk
    n_comp = len(pos)
    swc = sw.reshape(n_chunks, chunk, w)
    payc = pay.reshape(n_chunks, chunk)
    posc = tuple(p.reshape(n_chunks, chunk) for p in pos)

    def fwd(carry, inp):
        prev_row, carries = carry
        swk, payk = inp
        prev_w = jnp.concatenate([prev_row[None, :], swk[:-1]])
        ng = jnp.any(swk != prev_w, axis=-1)
        in_code = payk & U32(0xFF)
        out_code = (payk >> 8) & U32(0xFF)
        ext_bits = jnp.where(
            in_code < 4, U32(1) << in_code, U32(0)
        ) | jnp.where(out_code < 4, U32(1) << (out_code + 8), U32(0))
        n_counts = (in_code == 4).astype(U32) | (
            (out_code == 4).astype(U32) << 16
        )
        ones = jnp.ones(chunk, U32)
        p, carries_out = sg._fwd_chunk(
            (ext_bits, n_counts, ones), ng, carries, ops=_JUDGE_OPS
        )
        return (swk[-1], carries_out), (ng,) + p

    init = (~sw[0], (U32(0), U32(0), U32(0)))
    _, fwd_out = jax.lax.scan(fwd, init, (swc, payc))
    ngs, p_bits, p_counts, p_size = fwd_out

    def bwd(carry, inp):
        next_carries, next_cont = carry
        pb, pc, ps, ng = inp
        fin, carry_prev, cont_prev = sg._bwd_chunk(
            (pb, pc, ps), ng, next_carries, next_cont, ops=_JUDGE_OPS
        )
        return (carry_prev, cont_prev), fin

    init_b = (
        (p_bits[-1, -1], p_counts[-1, -1], p_size[-1, -1]),
        jnp.asarray(False),
    )
    _, (bits, counts, size) = jax.lax.scan(
        bwd, init_b, (p_bits, p_counts, p_size, ngs), reverse=True
    )

    def popcount4(x):
        return (
            (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)
        ).astype(jnp.int32)

    tab_buf0 = jnp.full((m + chunk, w), SENTINEL_WORD, U32)
    op_buf0 = tuple(jnp.zeros(m + chunk, U32) for _ in range(n_comp))
    oi_buf0 = jnp.zeros(m + chunk, jnp.int32)
    idx = jnp.arange(chunk, dtype=U32)

    def fin(carry, inp):
        rank_c, tg, tj, to, tab_buf, op_buf, oi_buf, off_t, off_o = carry
        swk, payk, posk, ngk, bitsk, countsk, sizek = inp
        is_rc = ((payk >> 16) & U32(1)) > 0
        real = ((payk >> 17) & U32(1)) > 0
        n_in = (countsk & U32(0xFFFF)).astype(jnp.int32)
        n_out = (countsk >> 16).astype(jnp.int32)
        indeg = popcount4(bitsk & U32(0xF)) + n_in
        outdeg = popcount4((bitsk >> 8) & U32(0xF)) + n_out
        keep = ((indeg > 1) | (outdeg > 1)) & real
        if check_abundance:
            keep = keep & (sizek.astype(jnp.uint64) <= abundance)
        keep_first = ngk & keep
        rank = jnp.cumsum(keep_first.astype(jnp.int32)) + rank_c
        ids = jnp.where(keep, jnp.where(is_rc, -rank, rank), 0)

        # stable partitions: kept rows first, order preserved; each
        # chunk's junk tail is overwritten by the next chunk's write
        # (and never read past the final totals)
        cols = jax.lax.sort(
            ((~keep_first).astype(U32), idx)
            + tuple(swk[:, i] for i in range(w)),
            num_keys=2,
        )
        cnt_t = jnp.sum(keep_first, dtype=jnp.int32)
        tab_buf = jax.lax.dynamic_update_slice(
            tab_buf, jnp.stack(cols[2:], axis=-1), (off_t, jnp.int32(0))
        )
        cols2 = jax.lax.sort(
            ((~keep).astype(U32), idx) + posk + (ids,), num_keys=2
        )
        cnt_o = jnp.sum(keep, dtype=jnp.int32)
        op_buf = tuple(
            jax.lax.dynamic_update_slice(b, c, (off_o,))
            for b, c in zip(op_buf, cols2[2 : 2 + n_comp])
        )
        oi_buf = jax.lax.dynamic_update_slice(
            oi_buf, cols2[2 + n_comp], (off_o,)
        )
        carry = (
            rank[-1],
            tg + jnp.sum(ngk & real, dtype=jnp.int64),
            tj + cnt_t.astype(jnp.int64),
            to + cnt_o.astype(jnp.int64),
            tab_buf,
            op_buf,
            oi_buf,
            off_t + cnt_t,
            off_o + cnt_o,
        )
        return carry, None

    init_f = (
        jnp.int32(0),
        jnp.int64(0),
        jnp.int64(0),
        jnp.int64(0),
        tab_buf0,
        op_buf0,
        oi_buf0,
        jnp.int32(0),
        jnp.int32(0),
    )
    carry, _ = jax.lax.scan(
        fin, init_f, (swc, payc, posc, ngs, bits, counts, size)
    )
    _r, n_groups, n_junc, n_occ, tab_buf, op_buf, oi_buf, _t, _o = carry
    return tab_buf, op_buf, oi_buf, n_groups, n_junc, n_occ


def _stream_single_round(dev_batches, buf_slots, cfg, *, wide=False):
    """Single-round buffer: stream every batch through
    build_sort_records with direct whole-batch appends — rows land at
    row0*P <= buf_slots - B*P, never clamped, so no compaction is
    needed (multi-round streaming uses _stream_round_scan instead)."""
    low_d, high_d = jnp.uint32(0), jnp.uint32(0xFFFFFFFF)
    n_comp = 2 if wide else 1
    buf_w = jnp.full((buf_slots, cfg.w), SENTINEL_WORD, U32)
    buf_pay = jnp.zeros(buf_slots, U32)
    buf_pos = tuple(jnp.zeros(buf_slots, U32) for _ in range(n_comp))
    for codes_d, valid_d, row0 in dev_batches:
        words, payload, pos = build_sort_records(
            codes_d, valid_d, _pos_base(row0, cfg.P, wide),
            low_d, high_d, cfg=cfg,
        )
        buf_w, buf_pay, buf_pos = append_records(
            buf_w, buf_pay, buf_pos, words, payload, pos,
            jnp.int32(row0 * cfg.P),
        )
    return buf_w, buf_pay, buf_pos


@partial(jax.jit, static_argnames=("cfg", "buf_slots"))
def _stream_round_scan(codes_st, valid_st, base_st, low, high, *, cfg, buf_slots):
    """All stacked batches -> one round's sentinel-padded sort buffer in
    ONE compiled program: lax.scan over batches (build records, compact
    the in-round ones, append). Replaces 2 dispatches per batch per
    round with 1 dispatch per round — at hundreds of rounds x hundreds
    of batches (multi-Gbase inputs) the dispatch latency alone
    otherwise dominates (the reference's analogue is its sequential
    re-stream of FASTA each round, vertexenumerator.h:228-392).

    codes_st: stacked device batches — (packed (nb,B,RW), nmask
    (nb,B,NW)) or raw (nb,B,R); valid_st (nb,B); base_st: tuple of 1-2
    (nb,) u32 position-base columns (see _pos_base).

    Returns (buf_w, buf_pay, buf_pos tuple, overflow flag) — caller
    MUST check overflow (records past buf_slots - B*P were dropped).
    """
    bp = cfg.B * cfg.P
    n_comp = len(base_st)
    buf_w0 = jnp.full((buf_slots, cfg.w), SENTINEL_WORD, U32)
    buf_pay0 = jnp.zeros(buf_slots, U32)
    buf_pos0 = tuple(jnp.zeros(buf_slots, U32) for _ in range(n_comp))
    lim = jnp.int32(buf_slots - bp)

    def step(carry, xs):
        buf_w, buf_pay, buf_pos, off, over = carry
        codes, valid, base = xs
        words, payload, pos = build_sort_records(
            codes, valid, base, low, high, cfg=cfg
        )
        cw, cp, cpos, cnt = compact_batch_records(
            words, payload, pos, cap=bp
        )
        over = over | (off + cnt > lim)
        off_c = jnp.minimum(off, lim)  # clamped write is junk-safe:
        # the overflow flag is checked on host before results are used
        buf_w = jax.lax.dynamic_update_slice(
            buf_w, cw, (off_c, jnp.int32(0))
        )
        buf_pay = jax.lax.dynamic_update_slice(buf_pay, cp, (off_c,))
        buf_pos = tuple(
            jax.lax.dynamic_update_slice(b, p, (off_c,))
            for b, p in zip(buf_pos, cpos)
        )
        return (buf_w, buf_pay, buf_pos, off_c + cnt, over), None

    init = (buf_w0, buf_pay0, buf_pos0, jnp.int32(0), jnp.asarray(False))
    (buf_w, buf_pay, buf_pos, _off, over), _ = jax.lax.scan(
        step, init, (codes_st, valid_st, base_st)
    )
    return buf_w, buf_pay, buf_pos, over


def _stack_batches(dev_batches, P: int, wide: bool):
    """Stack per-batch device arrays along a new leading axis for
    _stream_round_scan; bases computed host-exact per batch."""
    first = dev_batches[0][0]
    if isinstance(first, tuple):
        codes_st = tuple(
            jnp.stack([b[0][c] for b in dev_batches])
            for c in range(len(first))
        )
    else:
        codes_st = jnp.stack([b[0] for b in dev_batches])
    valid_st = jnp.stack([b[1] for b in dev_batches])
    bases = [_pos_base(row0, P, wide) for _c, _v, row0 in dev_batches]
    base_st = tuple(
        jnp.stack([b[c] for b in bases]) for c in range(len(bases[0]))
    )
    return codes_st, valid_st, base_st


def _finish_round(sw, pay, pos, abundance, check_ab, chunk):
    """Judge + compact one sorted round on device (single dispatch).

    Fetches only the three 8-byte counts (which forces the round's
    execution — honest per-round timing) and returns pow2-bucketed
    device slices; the fetch helpers materialize them later, off the
    round critical path, on a host thread (no copy_to_host_async).
    Returns (table_dev (cap_t, w), op_dev tuple, oi_dev (cap_o,),
    n_groups, n_junc, n_occ)."""
    tab_buf, op_buf, oi_buf, n_groups, n_junc, n_occ = judge_compact_fused(
        sw, pay, pos, abundance, check_abundance=check_ab, chunk=chunk
    )
    n_groups, n_junc, n_occ = int(n_groups), int(n_junc), int(n_occ)
    m = op_buf[0].shape[0]
    # fetch tightly-bucketed slices, not whole buffers
    cap_t = _fetch_cap(n_junc, m)
    cap_o = _fetch_cap(n_occ, m)
    return (
        tab_buf[:cap_t],
        tuple(b[:cap_o] for b in op_buf),
        oi_buf[:cap_o],
        n_groups,
        n_junc,
        n_occ,
    )


# ---- 4-byte packed occurrence fetch ---------------------------------
#
# Occurrence collection moves the most bytes device-to-host on
# junction-dense runs. Instead of fetching (pos u32[, u32], id i32)
# = 8-12 bytes per occurrence, the device sorts each round's
# occurrences by position and emits one u32 per occurrence:
#
#   packed = delta << (lid_bits+1) | sign << lid_bits | local_rank
#
# with delta_bits + 1 + lid_bits = 32, the split chosen per round so
# the round's table fits lid_bits. A tiny exception table (index, full
# position) carries deltas >= 2^delta_bits — deltas sum to at most
# max_pos, so count(delta >= 2^d) <= n_slots >> d: with delta_bits >=
# _OCC_MIN_DELTA_BITS the exception buffer is statically bounded and
# can NEVER overflow. Host reconstructs positions with one cumsum + a
# per-exception segment rebase. Works for narrow AND wide (u32-pair)
# positions.

_OCC_MIN_DELTA_BITS = 11
_OCC_MAX_DELTA_BITS = 14


def _occ_pack_spec(n_junc: int, n_occ: int, n_slots: int):
    """delta_bits for this round's 4-byte packing, or None when packing
    does not apply (table too big for <= 20 lid bits, or occurrences so
    sparse that exceptions would dominate)."""
    lid_bits = max(n_junc.bit_length(), 1)
    delta_bits = min(_OCC_MAX_DELTA_BITS, 31 - lid_bits)
    if delta_bits < _OCC_MIN_DELTA_BITS:
        return None
    # expected exception rate ~ exp(-2^d / mean spacing): require
    # 2^d >= 2 * spacing (rate < e^-2 = 14%; exceptions cost 12B vs
    # the 4-12B/occurrence saved, so packing still wins comfortably)
    if (n_occ << delta_bits) < 2 * n_slots:
        return None
    return delta_bits


@partial(jax.jit, static_argnames=("exc_cap", "delta_bits"))
def _pack_occ(pos, oi, n_occ, *, exc_cap: int, delta_bits: int):
    """pos: 1-tuple (narrow) or 2-tuple (hi, lo) of (cap,) u32 columns;
    oi (cap,) i32 signed 1-based round-local ranks; first n_occ live.
    -> (packed (cap,) u32 position-sorted, exc_idx (exc_cap,) u32
    [0xFFFFFFFF-terminated], exc_hi, exc_lo (exc_cap,) u32)."""
    cap = oi.shape[0]
    lid_bits = 31 - delta_bits
    idx = jnp.arange(cap, dtype=U32)
    live = idx < n_occ
    if len(pos) == 1:
        lo = jnp.where(live, pos[0], jnp.uint32(0xFFFFFFFF))
        lo_s, oi_s = jax.lax.sort((lo, oi), num_keys=1)
        hi_s = jnp.zeros(cap, U32)
        plo = jnp.concatenate([jnp.zeros(1, U32), lo_s[:-1]])
        dlo = lo_s - plo
        small = dlo < U32(1 << delta_bits)
    else:
        hi = jnp.where(live, pos[0], jnp.uint32(0xFFFFFFFF))
        lo = jnp.where(live, pos[1], jnp.uint32(0xFFFFFFFF))
        hi_s, lo_s, oi_s = jax.lax.sort((hi, lo, oi), num_keys=2)
        phi = jnp.concatenate([jnp.zeros(1, U32), hi_s[:-1]])
        plo = jnp.concatenate([jnp.zeros(1, U32), lo_s[:-1]])
        dlo = lo_s - plo
        borrow = (lo_s < plo).astype(U32)
        dhi = hi_s - phi - borrow
        small = (dhi == 0) & (dlo < U32(1 << delta_bits))
    delta = jnp.where(small, dlo, U32(0))
    lid = jnp.abs(oi_s).astype(U32)
    sign = (oi_s < 0).astype(U32)
    exc = (~small) & live  # live rows sorted first; rest are sentinels
    packed = (
        (delta << U32(lid_bits + 1)) | (sign << U32(lid_bits)) | lid
    )
    exc_key = jnp.where(exc, idx, jnp.uint32(0xFFFFFFFF))
    exc_idx, exc_hi, exc_lo = jax.lax.sort(
        (exc_key, hi_s, lo_s), num_keys=1
    )
    return (
        packed,
        exc_idx[:exc_cap],
        exc_hi[:exc_cap],
        exc_lo[:exc_cap],
        jnp.sum(exc, dtype=jnp.int32),
    )


def _unpack_occ(packed, exc_idx, exc_hi, exc_lo, delta_bits):
    """Host inverse of _pack_occ for one round: (pos int64, sign bool,
    lid u32) with positions ascending.

    All multi-hundred-MB temporaries come from the shared-anon pool
    (hostmem.big_empty) with explicit out= buffers: fresh private-anon
    numpy allocations fault at ~12-25 s/GB on this VM (measured; the
    allocation-per-ufunc version spent 18 s/round at 25M occurrences
    where this one spends ~1 s)."""
    n = len(packed)
    lid_bits = 31 - delta_bits
    n_exc = int(np.searchsorted(exc_idx, np.uint32(0xFFFFFFFF)))
    lid = np.bitwise_and(
        packed, np.uint32((1 << lid_bits) - 1), out=big_empty(n, np.uint32)
    )
    sign = np.right_shift(
        packed, np.uint32(lid_bits), out=big_empty(n, np.uint32)
    )
    np.bitwise_and(sign, np.uint32(1), out=sign)
    deltas = np.right_shift(
        packed, np.uint32(lid_bits + 1), out=big_empty(n, np.uint32)
    )
    pos = np.cumsum(deltas, dtype=np.int64, out=big_empty(n, np.int64))
    # each exception opens a segment rebased to its true position
    exc_pos = (exc_hi[:n_exc].astype(np.int64) << 32) | exc_lo[
        :n_exc
    ].astype(np.int64)
    bounds = np.append(exc_idx[:n_exc], n).astype(np.int64)
    for j in range(n_exc):
        a, b = bounds[j], bounds[j + 1]
        pos[a:b] += exc_pos[j] - pos[a]
    sign_b = np.not_equal(sign, 0, out=big_empty(n, np.bool_))
    return pos, sign_b, lid


def _fetch_round_exact(tab_d, op_d, oi_d, n_junc, n_occ):
    """Fetch one round's bucketed device slices and trim to exact
    sizes -> (table (n_junc, w), "raw", (pos component tuple, ids))."""
    return (
        np.asarray(tab_d)[:n_junc],
        "raw",
        (
            tuple(np.asarray(c)[:n_occ] for c in op_d),
            np.asarray(oi_d)[:n_occ],
        ),
    )


def _fetch_round_packed(
    tab_d, packed_d, exc_i_d, exc_hi_d, exc_lo_d, n_junc, n_occ,
    delta_bits,
):
    """Fetch one round in 4-byte packed form -> (table, "packed",
    (packed u32 (n_occ,), exc_idx, exc_hi, exc_lo, delta_bits))."""
    return (
        np.asarray(tab_d)[:n_junc],
        "packed",
        (
            np.asarray(packed_d)[:n_occ],
            np.asarray(exc_i_d),
            np.asarray(exc_hi_d),
            np.asarray(exc_lo_d),
            delta_bits,
        ),
    )


def _round_raw_occ(kind, payload):
    """(kind, payload) -> (occ_pos int64, signed local ids int) for the
    unpacked merge path."""
    if kind == "raw":
        opc, oi = payload
        return _host_pos(opc), oi
    pos, sign, lid = _unpack_occ(*payload)
    oi = lid.astype(np.int64)
    np.negative(oi, where=sign, out=oi)
    return pos, oi


def _fetch_cap(count: int, hard_max: int) -> int:
    """Fetch-slice bucket: multiple of 2^(bits-4) >= count (<=6.25%
    over, where pow2 buckets would fetch up to 2x); finer buckets trade
    a few extra tiny slice programs (compiled once, cached) for less
    device-to-host transfer."""
    count = max(count, 1)
    if count >= hard_max:
        return hard_max
    g = 1 << max(count.bit_length() - 4, 0)
    return min(-(-count // g) * g, hard_max)


class _Checkpoint(RoundCheckpoint):
    """Sort-engine round checkpoint: per-round junction table +
    occurrence stream (see pipeline.RoundCheckpoint for the guard)."""

    def __init__(
        self, directory, config: PipelineConfig, n_slots, intervals,
        fingerprint=None, read_only: bool = False,
    ):
        super().__init__(
            directory,
            dict(
                k=config.k,
                abundance=config.abundance,
                n_slots=int(n_slots),
                intervals=[list(map(int, iv)) for iv in intervals],
                # input identity: a changed input must invalidate the
                # checkpoint even when the padded slot count matches
                fingerprint=fingerprint,
                version=2,
            ),
            read_only=read_only,
        )

    def load_round(self, r: int):
        """-> ((table, kind, payload) fetched-style entry, rstats)."""
        got = super().load_round(r)
        if got is None:
            return None
        arrays, rstats = got
        if "packed" in arrays:
            entry = (
                arrays["table"],
                "packed",
                (
                    arrays["packed"],
                    arrays["exc_i"],
                    arrays["exc_hi"],
                    arrays["exc_lo"],
                    int(arrays["delta_bits"]),
                ),
            )
        else:
            entry = (
                arrays["table"],
                "raw",
                ((arrays["occ_pos"],), arrays["occ_ids"]),
            )
        return entry, rstats

    def save_round(self, r, entry, rstats) -> None:
        table, kind, payload = entry
        if kind == "packed":
            packed, exc_i, exc_hi, exc_lo, delta_bits = payload
            super().save_round(
                r, rstats, table=table, packed=packed, exc_i=exc_i,
                exc_hi=exc_hi, exc_lo=exc_lo,
                delta_bits=np.int64(delta_bits),
            )
        else:
            opc, oi = payload
            super().save_round(
                r, rstats, table=table, occ_pos=_host_pos(opc),
                occ_ids=oi,
            )


def _complete_checkpoint_intervals(
    directory, config: PipelineConfig, n_slots, fingerprint
):
    """Intervals of a COMPLETE matching checkpoint, else None.

    'Matching' = the stored meta.json equals what this run would write
    for every key EXCEPT the interval list itself (which is exactly the
    data being recovered — it can differ from a fresh split when the
    resident partition re-split on overflow); 'complete' = a
    round_<r>.npz exists for every stored interval."""
    import json

    meta_path = os.path.join(directory, "meta.json")
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    ivs = meta.get("intervals")
    if not ivs:
        return None
    probe = dict(
        k=config.k,
        abundance=config.abundance,
        n_slots=int(n_slots),
        intervals=ivs,
        fingerprint=fingerprint,
        version=2,
    )
    if meta != probe:
        return None
    if not all(
        os.path.exists(os.path.join(directory, f"round_{r}.npz"))
        for r in range(len(ivs))
    ):
        return None
    return [tuple(iv) for iv in ivs]


def build_junctions_sorted(
    input_paths: Sequence[str] | None,
    config: PipelineConfig,
    out_path: str | None = None,
    sequences: Sequence[tuple[int, np.ndarray]] | None = None,
    log: Callable[[str], None] = lambda s: None,
    checkpoint_dir: str | None = None,
) -> Enumerator:
    """Sort-join counterpart of pipeline.build_junctions (same contract)."""
    cfg = config.pass_config(filterless=True)
    wcfg = config.window_config()
    stats = RunStats()
    t_start = time.time()

    t0 = time.time()
    if sequences is None:
        sequences = [
            (sid, codes)
            for sid, _hdr, codes in fasta_io.read_all_records(input_paths)
        ]
    stats.timings["read"] = time.time() - t0
    t0 = time.time()
    batches = list(windows.iter_window_batches(iter(sequences), wcfg))
    stats.total_positions = sum(int(b.valid.sum()) for b in batches)
    stats.timings["windows"] = time.time() - t0
    n_rows = len(batches) * cfg.B
    n_slots = n_rows * cfg.P
    # beyond 2^32 flat positions (~4.2 Gbases) records carry a second
    # u32 position column (the reference's size_t positions never cap,
    # vertexenumerator.h:935-958); TWOPACO_POS64=1 forces it for tests
    wide = (
        n_slots >= 1 << 32
        or getattr(config, "force_wide", False)
        or os.environ.get("TWOPACO_POS64") == "1"
    )
    resident_bytes = _resident_bytes()
    log(
        f"Engine = sort-join\nVertex length = {config.k}\n"
        f"Record slots = {n_slots}\nCapacity = {cfg.w} words\n"
        f"Resident budget = {resident_bytes} bytes"
    )

    # upload 2-bit packed + N bitmask (2.25 bits/char): H2D volume and
    # HBM residency are ~3.6x smaller than raw uint8 codes
    # (TWOPACO_PACK_TRANSFER=0 uploads raw codes, for perf bisection)
    t0 = time.time()
    if os.environ.get("TWOPACO_PACK_TRANSFER", "1") != "0":
        dev_batches = [
            (
                tuple(map(jnp.asarray, pack.pack_codes_host(b.codes))),
                jnp.asarray(b.valid),
                b.row0,
            )
            for b in batches
        ]
    else:
        dev_batches = [
            (jnp.asarray(b.codes), jnp.asarray(b.valid), b.row0)
            for b in batches
        ]
    stats.timings["upload"] = time.time() - t0

    # auto-rounds: cap the per-round sort size (compile/memory bound) —
    # the reference's -r memory knob generalized; we honor at least the
    # requested count (README.md:94-101 semantics). The buffer size is
    # derived from sort_chunk and padded; the round count then uses the
    # buffer's REAL capacity (buffer minus append headroom, derated by
    # round_slack for hash-mass imbalance) so padding isn't wasted.
    max_sort = config.sort_chunk
    bp = cfg.B * cfg.P
    raw_buf = min(n_slots, int(max_sort * config.round_slack) + bp) + bp
    padded_buf = (
        -(-raw_buf // JUDGE_CHUNK) * JUDGE_CHUNK
        if raw_buf > JUDGE_CHUNK
        else raw_buf
    )
    capacity = max(1, int((padded_buf - bp) / config.round_slack))
    # an input that fits the sort buffer outright is ALWAYS one round
    # (direct appends fill exactly n_slots — the slack derate only
    # covers hash-mass imbalance between multi-round intervals)
    if n_slots <= max_sort:
        n_rounds = max(config.rounds, 1)
    else:
        n_rounds = max(config.rounds, -(-n_slots // capacity))
    bin_pow = 16
    n_batches = len(batches)
    check_ab = config.abundance < (1 << 64) - 1
    abundance_d = jnp.uint64(config.abundance)
    hist = None

    # resident-parts mode (multi-round): build + partition every record
    # ONCE into per-batch fixed-cap round blocks held in HBM; each round
    # is then assemble -> sort -> fused judge/compact. The stream mode
    # below re-builds records every round (the analogue of the
    # reference re-streaming FASTA per round, vertexenumerator.h:228) —
    # kept for inputs whose records exceed the resident byte budget.
    # blocks store (w words, payload, in-batch offset) per slot —
    # positions are rebuilt from the batch base at assemble time, so
    # wide runs don't pay a second position column in resident HBM
    rec_bytes = 4 * (cfg.w + 2)
    resident = (
        n_rounds > 1
        and int(n_slots * config.round_slack * rec_bytes)
        <= resident_bytes
        and os.environ.get("TWOPACO_RESIDENT", "1") != "0"
    )
    stacked = None  # stacked batches for the scanned passes
    base_st = None  # batch bases: assemble_round rebuilds positions
    if n_rounds > 1:
        t0 = time.time()
        stacked = _stack_batches(dev_batches, cfg.P, wide)
        base_st = stacked[2]
        stats.timings["hist_stack"] = time.time() - t0
        if os.environ.get("TWOPACO_UNIFORM_SPLIT", "1") != "0":
            # Buzhash values are near-uniform, so a uniform split of the
            # hash space balances rounds to ~sqrt(records/round) — the
            # resident path re-splits on overflow anyway. This skips a
            # full sampled scan + its forcing fetch (0.5s at 64 Mbase,
            # much more at Gbase scale where it absorbs the H2D wait).
            # The reference's counter pass is vertexenumerator.h:503-583.
            hist = np.ones(1 << bin_pow, np.int64)
            stats.timings["hist"] = time.time() - t0 - stats.timings[
                "hist_stack"
            ]
        else:
            # sample ~2^23 positions: ~1% interval-mass accuracy
            hist_stride = max(1, 1 << max(0, n_slots.bit_length() - 24))
            t1 = time.time()
            hist_d = _histogram_scan(
                stacked[0], stacked[1],
                cfg=cfg, bin_pow=bin_pow, stride=hist_stride,
            )
            stats.timings["hist_dispatch"] = time.time() - t1
            hist = np.asarray(hist_d)
            stats.timings["hist"] = time.time() - t1

    # input fingerprint early: the resident resume fast path below
    # needs it before the checkpoint object exists
    fingerprint = None
    if checkpoint_dir is not None:
        fingerprint = _input_fingerprint(input_paths, sequences)

    parts_w = parts_pay = parts_pos = None
    groups = None  # grouped-resident plan (records exceed HBM budget)
    n_inner = 0
    resumed_all = False
    t0 = time.time()
    if resident and checkpoint_dir is not None:
        # resume fast path: a COMPLETE matching checkpoint already
        # holds the final (overflow-resplit) intervals — restore every
        # round without paying the full-input partition scan, the
        # dominant device phase of a resident build
        resume_iv = _complete_checkpoint_intervals(
            checkpoint_dir, config, n_slots, fingerprint
        )
        if resume_iv is not None:
            intervals = resume_iv
            buf_slots = padded_buf  # unused: every round restores
            del dev_batches, stacked
            stacked = None
            resident = False  # the round loop must not touch parts
            resumed_all = True
            log(
                f"All {len(intervals)} resident rounds checkpointed — "
                "skipping partition"
            )
    stream_rounds = False  # resident blocks could not be balanced
    if resident:
        n_stream_rounds = n_rounds
        # R from the buffer's full capacity (no append headroom needed)
        n_rounds = max(
            config.rounds,
            -(-int(n_slots * config.round_slack) // padded_buf),
        )
        for _attempt in range(6):
            intervals = [
                iv
                for iv in _split_rounds(hist, n_rounds, bin_pow)
                if iv[0] <= iv[1]
            ]
            part_cap = -(-int(config.round_slack * bp) // len(intervals))
            highs = np.asarray([h for _l, h in intervals], np.uint32)
            assert (np.diff(highs.astype(np.int64)) > 0).all()
            highs_d = jnp.asarray(highs)
            parts_w, parts_pay, parts_pos, counts_d = _partition_scan(
                *stacked, highs_d, jnp.uint32(0), jnp.uint32(0xFFFFFFFF),
                cfg=cfg, n_parts=len(intervals), part_cap=part_cap,
            )
            counts = np.asarray(counts_d)
            if (counts <= part_cap).all():
                break
            # a batch's round block overflowed its fixed cap (local
            # k-mer-hash skew): split finer and re-partition
            del parts_w, parts_pay, parts_pos
            n_rounds = -(-n_rounds * 3) // 2
            log(
                f"Round block overflow (max {int(counts.max())} > "
                f"{part_cap}); re-splitting into {n_rounds} rounds"
            )
        else:
            # the hash mass sits on too few distinct values for any split
            # to even out per-batch blocks (tiny k, low-complexity input):
            # stream the rounds, whose buffers are checked per round
            log(
                "Round block overflow persists after re-splitting; "
                "streaming the rounds instead"
            )
            resident, stream_rounds = False, True
            n_rounds = n_stream_rounds
        if resident:
            del dev_batches, stacked  # codes no longer needed on device
            stacked = None
            buf_slots = n_batches * part_cap
            if buf_slots > JUDGE_CHUNK:
                buf_slots = -(-buf_slots // JUDGE_CHUNK) * JUDGE_CHUNK
            stats.timings["partition"] = time.time() - t0
            log(
                f"Splitting the input kmers set ({len(intervals)} rounds, "
                f"resident parts, block cap {part_cap})"
            )
    if resumed_all or resident:
        pass
    elif (
        n_rounds > 1
        and not stream_rounds
        and os.environ.get("TWOPACO_GROUPED", "1") != "0"
    ):
        # grouped resident: records exceed the HBM budget, so process
        # the hash space in groups — ONE full-input partition scan per
        # group (not per round), each group's records resident while
        # its inner rounds run. The per-round stream engine re-scanned
        # the whole input every round (reference-style,
        # vertexenumerator.h:228-392): at 5 Gbases that is ~150 scans;
        # grouping cuts it to ceil(record_bytes / budget) ~ 20.
        total_bytes = int(n_slots * config.round_slack * rec_bytes)
        n_groups = min(max(2, -(-total_bytes // resident_bytes)), n_rounds)
        n_inner = -(-n_rounds // n_groups)
        groups, intervals = _plan_groups(hist, n_groups, n_inner, bin_pow)
        part_cap = -(-int(config.round_slack * bp) // (
            len(groups) * n_inner
        ))
        buf_slots = n_batches * part_cap
        if buf_slots > JUDGE_CHUNK:
            buf_slots = -(-buf_slots // JUDGE_CHUNK) * JUDGE_CHUNK
        stats.timings["partition_plan"] = time.time() - t0
        log(
            f"Splitting the input kmers set ({len(intervals)} rounds in "
            f"{len(groups)} resident groups, block cap {part_cap})"
        )
    elif n_rounds > 1:
        # drop inverted (empty) intervals a skewed sampled histogram
        # can produce — each would dispatch a full zero-record round
        intervals = [
            iv
            for iv in _split_rounds(hist, n_rounds, bin_pow)
            if iv[0] <= iv[1]
        ]
        buf_slots = padded_buf
        log(f"Splitting the input kmers set ({len(intervals)} rounds)")
    else:
        intervals = [(0, 0xFFFFFFFF)]
        # single round: direct whole-batch appends fill exactly n_slots
        # (rows land at row0*P <= n_slots - B*P, never clamped); the
        # buffer is bucketed (pow2 below JUDGE_CHUNK, JUDGE_CHUNK
        # multiples above) so arbitrary input sizes reuse a bounded set
        # of compiled sort/judge programs — a compile per distinct shape
        # would otherwise dominate serving unseen small genomes. Tail
        # slots are sentinels the judge drops.
        buf_slots = _bucket_slots(n_slots)

    # checkpoint/resume at round boundaries (the reference keeps
    # intermediate files but has no resume, SURVEY.md §5); rounds are
    # deterministic so completed ones can be reloaded verbatim
    ckpt = _Checkpoint(
        checkpoint_dir, config, n_slots, intervals, fingerprint
    )

    fetcher = None
    # per-round results in round order: Futures (fast path), ("entry",
    # fetched-entry) (durable/restored), or ("defer", fetch_args)
    pending: list = []
    if (
        checkpoint_dir is None
        and os.environ.get("TWOPACO_FETCH_THREAD", "1") != "0"
    ):
        from concurrent.futures import ThreadPoolExecutor

        fetcher = ThreadPoolExecutor(max_workers=1)
    # exception capacity for the 4-byte packed fetch: deltas sum to at
    # most max_pos, so at most n_slots >> delta_bits reach 2^delta_bits
    # (+1 for the round's first record) — statically safe at the
    # minimum split, never overflows
    occ_exc_cap = _next_pow2(
        max((n_slots >> _OCC_MIN_DELTA_BITS) + 2, 16)
    )
    judge_chunk = min(JUDGE_CHUNK, buf_slots)
    if stacked is not None:
        dev_batches = None  # scan-stream rounds use the stacked form

    # grouped-resident bookkeeping: round -> part index within its
    # group, and the rounds at which a new group's partition scan runs
    part_of_round: list[int] = []
    group_at: dict[int, tuple] = {}
    if groups is not None:
        for glow, ghigh, g_rounds in groups:
            group_at[len(part_of_round)] = (
                glow, ghigh, [hi for _l, hi, _p in g_rounds],
                len(g_rounds),
            )
            part_of_round.extend(p for _l, _h, p in g_rounds)

    for r, (low, high) in enumerate(intervals):
        if r in group_at:
            glow, ghigh, g_highs, n_real = group_at[r]
            if not all(ckpt.has_round(r + j) for j in range(n_real)):
                # ONE full-input scan partitions this group's records
                # into resident per-round blocks (frees the previous
                # group's blocks first — two sets would not fit HBM)
                parts_w = parts_pay = parts_pos = None
                tp = time.time()
                highs_pad = np.asarray(
                    g_highs + [ghigh] * (n_inner - n_real), np.uint32
                )
                parts_w, parts_pay, parts_pos, counts_d = _partition_scan(
                    *stacked, jnp.asarray(highs_pad),
                    jnp.uint32(glow), jnp.uint32(ghigh),
                    cfg=cfg, n_parts=n_inner, part_cap=part_cap,
                )
                counts = np.asarray(counts_d)
                if (counts[:, :n_real] > part_cap).any():
                    raise RuntimeError(
                        "grouped round block overflow (max "
                        f"{int(counts.max())} > {part_cap}) — raise "
                        "PipelineConfig.round_slack"
                    )
                stats.timings["partition"] = (
                    stats.timings.get("partition", 0.0)
                    + time.time() - tp
                )
        restored = ckpt.load_round(r)
        if restored is not None:
            entry, rstats = restored
            pending.append(("entry", entry))
            stats.rounds.append(rstats)
            log(f"Round {r}: restored from checkpoint")
            continue
        if resumed_all:
            # _complete_checkpoint_intervals saw every round file; one
            # vanishing mid-resume must not fall through to a compute
            # path whose inputs (stacked/parts) were already released
            raise RuntimeError(
                f"checkpoint round {r} disappeared during resume"
            )
        log(f"Round {r}, {low}:{high}")
        t0 = time.time()
        if resident or groups is not None:
            pidx = r if resident else part_of_round[r]
            buf_w, buf_pay, buf_pos = assemble_round(
                jnp.int32(pidx), parts_w, parts_pay, parts_pos,
                base_st, buf_slots=buf_slots,
            )
        elif len(intervals) == 1:
            buf_w, buf_pay, buf_pos = _stream_single_round(
                dev_batches, buf_slots, cfg, wide=wide,
            )
        else:
            buf_w, buf_pay, buf_pos, over = _stream_round_scan(
                *stacked, jnp.uint32(low), jnp.uint32(high),
                cfg=cfg, buf_slots=buf_slots,
            )
            if bool(over):
                raise RuntimeError(
                    "round record buffer overflow — increase rounds "
                    "(-r) or PipelineConfig.round_slack"
                )
        t_build = time.time() - t0

        t0 = time.time()
        sw, pay, pos = sort_records(buf_w, buf_pay, buf_pos, w=cfg.w)
        t_sort = time.time() - t0

        t0 = time.time()
        tab_d, op_d, oi_d, n_groups, n_junc, n_occ = _finish_round(
            sw, pay, pos, abundance_d, check_ab, judge_chunk
        )
        spec = (
            _occ_pack_spec(n_junc, n_occ, n_slots) if n_occ > 0 else None
        )
        if spec is not None:
            # dense round: 4 bytes/occurrence device-to-host (and 3x
            # smaller round checkpoints)
            packed, exc_i, exc_hi, exc_lo, n_exc_d = _pack_occ(
                op_d, oi_d, jnp.uint32(n_occ),
                exc_cap=occ_exc_cap, delta_bits=spec,
            )
            # fetch exceptions by exact count (the statically-safe
            # buffer can be tens of MB at Gbase scale)
            ecf = _fetch_cap(max(int(n_exc_d), 1), occ_exc_cap)
            fetch_args = (
                _fetch_round_packed, tab_d, packed, exc_i[:ecf],
                exc_hi[:ecf], exc_lo[:ecf], n_junc, n_occ, spec,
            )
        else:
            fetch_args = (
                _fetch_round_exact, tab_d, op_d, oi_d, n_junc, n_occ,
            )
        if fetcher is not None:
            # fast path: a background thread pulls the finished round's
            # results to the host WHILE the next rounds compute
            pending.append(fetcher.submit(*fetch_args))
        elif checkpoint_dir is not None:
            # durable path: materialize now so the round can be saved
            pending.append(("entry", fetch_args[0](*fetch_args[1:])))
        else:
            # escape hatch (TWOPACO_FETCH_THREAD=0): materialize after
            # the loop; async D2H copies overlap the next rounds
            pending.append(("defer", fetch_args))
        t_finish = time.time() - t0
        del sw, pay, pos
        stats.rounds.append(
            dict(
                low=low,
                high=high,
                marks=n_occ,
                hash_table_size=n_groups,
                true_junctions=n_junc,
                false_positives=0,
                # t_build/t_sort are async dispatch walls; t_finish
                # includes the waits + fetches (the honest per-round
                # total is their sum; per-phase device attribution
                # needs a profiler trace, --tpu-profile)
                t_build=t_build,
                t_sort=t_sort,
                t_finish=t_finish,
            )
        )
        log(
            f"Assemble\t{t_build:.1f}\nSort\t{t_sort:.1f}\n"
            f"Judge+compact\t{t_finish:.1f}\nTrue junctions = {n_junc}\n"
            f"Distinct k-mers = {n_groups}\nOccurrences = {n_occ}"
        )
        if checkpoint_dir is not None:
            ckpt.save_round(r, pending[-1][1], stats.rounds[-1])

    parts_w = parts_pay = parts_pos = None  # release resident parts
    # round-loop walls rolled up so the timings dict attributes the
    # full run (per-round detail stays in stats.rounds)
    for key in ("t_build", "t_sort", "t_finish"):
        stats.timings["rounds_" + key[2:]] = sum(
            r.get(key, 0.0) for r in stats.rounds
        )
    # collect the (thread-overlapped) copies
    t0 = time.time()
    fetched = []
    for e in pending:
        if hasattr(e, "result"):
            fetched.append(e.result())
        elif e[0] == "entry":
            fetched.append(e[1])
        else:
            fn, *args = e[1]
            fetched.append(fn(*args))
    if fetcher is not None:
        fetcher.shutdown()
    stats.timings["collect"] = time.time() - t0
    return merge_fetched(
        fetched, batches, cfg, config, out_path, stats, log, t_start,
        n_slots=n_slots, wide=wide, n_sequences=len(sequences),
    )


def merge_fetched(
    fetched, batches, cfg, config, out_path, stats, log, t_start,
    *, n_slots: int, wide: bool, n_sequences: int,
):
    """Shared engine tail: pick the packed-u64 merge when ids fit, else
    the generic int64 merge. fetched = [(table, kind, payload), ...]
    entries whose k-mer sets are disjoint (hash intervals x optional
    k-mer ranges partition the space); payload local ids are 1-based
    ranks into that entry's table rows."""
    total_j = sum(len(t) for t, _, _ in fetched)
    # u64 merge keys: pos in the high bits, biased signed id below.
    # Narrow runs use a fixed 32/32 split (u32-view fast paths);
    # wide runs split at the position width when ids still fit.
    pos_bits = 32 if not wide else max(n_slots.bit_length(), 33)
    id_bits = 64 - pos_bits
    if total_j + 2 * n_sequences + 64 < (1 << (id_bits - 1)):
        return merge_rounds_packed(
            fetched, batches, cfg, config, out_path, stats, log,
            t_start, pos_bits=pos_bits,
        )
    round_tables = [t for t, _, _ in fetched]
    round_occ = [_round_raw_occ(k, p) for _, k, p in fetched]
    return merge_rounds_and_emit(
        round_tables, round_occ, batches, cfg, config, out_path, stats,
        log, t_start,
    )


def _plan_groups(hist, n_groups: int, n_inner: int, bin_pow: int):
    """Two-level greedy split of the hash space for the grouped
    resident engine: n_groups outer intervals (each sized so one
    group's records fit the resident HBM budget), each sub-split into
    up to n_inner inner rounds.

    Returns (groups, flat_intervals): groups[g] = (glow, ghigh,
    [(low, high, part_idx), ...]); flat_intervals lists every round's
    (low, high) in global round order (checkpoint identity)."""
    shift = 32 - bin_pow
    groups = []
    flat = []
    for gl, gh in _split_rounds(hist, n_groups, bin_pow):
        if gl > gh:
            continue
        sub = np.zeros_like(hist)
        sub[gl >> shift : (gh >> shift) + 1] = hist[
            gl >> shift : (gh >> shift) + 1
        ]
        inner = []
        for lo, hi in _split_rounds(sub, n_inner, bin_pow):
            lo2, hi2 = max(lo, gl), min(hi, gh)
            if lo2 <= hi2:
                inner.append((lo2, hi2, len(inner)))
        if not inner:
            inner = [(gl, gh, 0)]
        groups.append((gl, gh, inner))
        flat.extend((lo, hi) for lo, hi, _p in inner)
    return groups, flat


def _merge_keys(cat: np.ndarray, w: int) -> np.ndarray:
    """Sort/search keys for (n, w) canonical k-mer word rows: u64
    integer keys when they fit (k <= 32) — same lexicographic word
    order, ~10x faster argsort/searchsorted than S8 strings."""
    if w == 1:
        return cat[:, 0].astype(np.uint64)
    if w == 2:
        return (cat[:, 0].astype(np.uint64) << 32) | cat[:, 1].astype(
            np.uint64
        )
    return dna.words_to_bytes_keys(cat)


def merge_rounds_packed(
    fetched, batches, cfg, config, out_path, stats, log, t_start,
    pos_bits: int = 32,
):
    """Fast merge: per-round occurrences are packed straight into ONE
    preallocated u64 key buffer (pos << id_bits | biased id, id_bits =
    64 - pos_bits) and sorted in place. The unpacked path
    (merge_rounds_and_emit) concatenates, argsorts and re-gathers
    several int64 arrays — at pangenome occurrence densities (126M
    occurrences for 62 E. coli strains) that cost minutes of
    demand-faulted page churn; this path touches one
    8-byte-per-occurrence buffer once. Caller guarantees positions fit
    pos_bits and |global id| + bias fits id_bits.

    fetched[r] = (table (nj, w) u32, kind, payload) where kind/payload
    is "raw"/((pos_comps,), ids) or "packed" (see _pack_occ)."""
    id_bits = 64 - pos_bits
    t0 = time.time()
    tables = [t for t, _, _ in fetched]
    n_tab = sum(len(t) for t in tables)
    if n_tab:
        cat = np.concatenate([t for t in tables if len(t)])
        keys = _merge_keys(cat, cfg.w)
        # unique keys (rounds partition the hash space), so an unstable
        # sort + its inverse permutation give every round's remap with
        # zero searches — per-round searchsorted into the global table
        # (53M keys at 5 Gbase scale) measured ~0.7s/round of cache
        # misses
        order = np.argsort(keys)
        table = np.ascontiguousarray(cat[order])
        sorted_keys = keys[order]
        if len(sorted_keys) > 1 and not bool(
            (sorted_keys[1:] > sorted_keys[:-1]).all()
        ):
            raise AssertionError(
                "duplicate junction keys across rounds — hash "
                "intervals must partition the k-mer space"
            )
        del sorted_keys
        inv = np.empty(len(keys), np.int64)
        inv[order] = np.arange(len(keys), dtype=np.int64)
    else:
        table = np.zeros((0, cfg.w), np.uint32)
        inv = np.zeros(0, np.int64)
    stats.timings["dict_table"] = time.time() - t0

    def occ_len(kind, payload):
        return len(payload[1] if kind == "raw" else payload[0])

    total_o = sum(occ_len(k, p) for _, k, p in fetched)
    buf = big_empty(total_o, np.uint64)
    ofs = 0
    row_ofs = 0
    bias = np.int64(1) << (id_bits - 1)
    for rtab, kind, payload in fetched:
        remap = inv[row_ofs : row_ofs + len(rtab)]
        row_ofs += len(rtab)
        n = occ_len(kind, payload)
        if n == 0:
            continue
        # out=-buffered passes throughout: each allocation-per-ufunc
        # costs a fresh private-anon first touch (~12-25 s/GB here)
        if kind == "raw":
            opc, oi = payload
            pos = opc[0] if len(opc) == 1 else _host_pos(opc)
            idx = np.abs(oi, out=big_empty(n, oi.dtype))
            np.subtract(idx, 1, out=idx)
            # mode="clip" is the fast path, so a corrupt id would
            # silently map to a plausible junction — keep the loud
            # last-line drop detector (CLAUDE.md invariant) explicit
            if int(idx.max(initial=0)) >= len(remap):
                raise RuntimeError(
                    f"occurrence id out of range: max index "
                    f"{int(idx.max())} >= table size {len(remap)}"
                )
            # id 0 is invalid too (|0|-1 = -1 would clip to junction
            # 0 silently; the packed path catches it via u32 wrap)
            if int(idx.min(initial=0)) < 0:
                raise RuntimeError("occurrence id 0 (corrupt round)")
            gid = np.take(
                remap, idx, out=big_empty(n, np.int64), mode="clip"
            )
            np.add(gid, 1, out=gid)
            neg = np.less(oi, 0, out=big_empty(n, np.bool_))
            np.negative(gid, where=neg, out=gid)
        else:
            pos, sign, lid = _unpack_occ(*payload)
            np.subtract(lid, np.uint32(1), out=lid)
            if int(lid.max(initial=0)) >= len(remap):
                raise RuntimeError(
                    f"occurrence local id out of range: max index "
                    f"{int(lid.max())} >= table size {len(remap)}"
                )
            gid = np.take(
                remap, lid, out=big_empty(n, np.int64), mode="clip"
            )
            np.add(gid, 1, out=gid)
            np.negative(gid, where=sign, out=gid)
        seg64 = buf[ofs : ofs + n]
        if pos_bits == 32:
            # write the two u32 halves through a view: numpy's
            # in-place u64 shift/or ufuncs measured ~20x slower
            seg = seg64.view(np.uint32).reshape(-1, 2)
            seg[:, 1] = pos  # u32 or int64 -> u32 cast
            np.add(gid, bias, out=gid)
            seg[:, 0] = gid  # int64 -> u32 cast on assignment
        else:
            np.left_shift(
                np.asarray(pos, np.int64).view(np.uint64),
                np.uint64(id_bits),
                out=seg64,
            )
            np.add(gid, bias, out=gid)
            np.bitwise_or(seg64, gid.view(np.uint64), out=seg64)
        ofs += n
    stats.timings["dict_remap"] = time.time() - t0
    buf.sort()
    stats.timings["dict"] = time.time() - t0

    stats.distinct_junctions = len(table)
    enum = Enumerator(table, config.k, stats)
    if out_path is not None:
        t0 = time.time()
        c0 = time.process_time()
        occurrences, n_stubs = emit_junctions_packed(
            out_path, batches, buf, len(table), cfg.P,
            timings=stats.timings, id_bits=id_bits,
        )
        stats.occurrences = occurrences
        stats.stub_ids = n_stubs
        stats.timings["emit"] = time.time() - t0
        stats.timings["emit_cpu"] = time.process_time() - c0
        log(f"True marks count: {occurrences}")
    stats.timings["total"] = time.time() - t_start
    log(f"Distinct junctions = {enum.vertices_count}")
    return enum


def merge_rounds_and_emit(
    round_tables, round_occ, batches, cfg, config, out_path, stats, log,
    t_start,
):
    """Shared tail of every sort-join engine (single-device and
    distributed): merge per-round junction tables into the global sorted
    dictionary, remap per-round local ids to global ranks, and emit the
    junction list (reference pass 4, vertexenumerator.h:856-993).

    round_occ[r] = (occ_pos, signed local ids where |id| = 1-based rank
    into round_tables[r]'s rows); any order — the global position sort
    happens here."""
    # ---- merge rounds: global dictionary + id remap --------------------
    t0 = time.time()

    def merge_keys(cat):
        return _merge_keys(cat, cfg.w)

    if sum(len(t) for t in round_tables):
        cat = np.concatenate([t for t in round_tables if len(t)])
        keys = merge_keys(cat)
        order = np.argsort(keys, kind="stable")
        table = np.ascontiguousarray(cat[order])
        global_keys = keys[order]
    else:
        table = np.zeros((0, cfg.w), np.uint32)
        global_keys = merge_keys(table)
    stats.timings["dict_table"] = time.time() - t0

    all_pos: list[np.ndarray] = []
    all_ids: list[np.ndarray] = []
    for rtab, (op, oi) in zip(round_tables, round_occ):
        if len(op) == 0:
            continue
        if len(rtab):
            rk = merge_keys(rtab)
            remap = np.searchsorted(global_keys, rk).astype(np.int64)
        else:
            remap = np.zeros(0, np.int64)
        sign = np.sign(oi).astype(np.int64)
        gid = remap[np.abs(oi) - 1] + 1
        # int64 positions: np.searchsorted with a python-int key against
        # a uint64 array silently falls off the fast path (O(n) per call)
        all_pos.append(op.astype(np.int64))
        all_ids.append(sign * gid)
    stats.timings["dict_remap"] = time.time() - t0

    if all_pos:
        total = sum(len(p) for p in all_pos)
        occ_pos = np.concatenate(all_pos, out=big_empty(total, np.int64))
        occ_ids = np.concatenate(all_ids, out=big_empty(total, np.int64))
        order = np.argsort(occ_pos, kind="stable")
        # mode="clip" (indices are in-bounds by construction) writes
        # straight into `out`; mode="raise" buffers through a temp
        occ_pos = np.take(
            occ_pos, order, out=big_empty(total, np.int64), mode="clip"
        )
        occ_ids = np.take(
            occ_ids, order, out=big_empty(total, np.int64), mode="clip"
        )
    else:
        occ_pos = np.zeros(0, np.int64)
        occ_ids = np.zeros(0, np.int64)
    stats.timings["dict"] = time.time() - t0
    return finish_emit(
        table, occ_pos, occ_ids, batches, cfg, config, out_path, stats,
        log, t_start,
    )


def finish_emit(
    table, occ_pos, occ_ids, batches, cfg, config, out_path, stats, log,
    t_start,
):
    """Common tail: build the Enumerator from the merged global table and
    write the junction list from the position-sorted occurrence stream."""
    stats.distinct_junctions = len(table)
    enum = Enumerator(table, config.k, stats)

    if out_path is not None:
        t0 = time.time()
        c0 = time.process_time()
        occurrences, n_stubs = emit_junctions(
            out_path, batches, occ_pos, occ_ids, len(table), cfg.P,
            timings=stats.timings,
        )
        stats.occurrences = occurrences
        stats.stub_ids = n_stubs
        stats.timings["emit"] = time.time() - t0
        # wall vs process CPU separates real work from waiting/contention
        stats.timings["emit_cpu"] = time.process_time() - c0
        log(f"True marks count: {occurrences}")

    stats.timings["total"] = time.time() - t_start
    log(f"Distinct junctions = {enum.vertices_count}")
    return enum
