"""The four TwoPaCo passes as jitted fixed-shape batch kernels.

Reference pipeline (vertexenumerator.h:122-466, SURVEY.md §0):
  pass 1  fill     — insert every (k+1)-mer edge into the Bloom filter
                     (FilterFillerWorker, vertexenumerator.h:995-1105)
  pass 2  mark     — probe 8 extensions per vertex, mark candidates
                     (CandidateCheckingWorker, vertexenumerator.h:586-704)
  pass 3  verify   — exact bifurcation test over candidate records
                     (CandidateFinalFilteringWorker + TrueBifurcations,
                     vertexenumerator.h:708-829,1228-1256)
  pass 4  lookup   — junction-id assignment per candidate occurrence
                     (EdgeConstructionWorker, vertexenumerator.h:856-993)

Design: every pass is a pure function over a WindowBatch's
(B, P) position grid. Edges and both strands are derived from the packed
vertex words with O(w) shifts (no per-edge repacking): for vertex V with
reverse complement V',
    out-edge V·c  has RC  comp(c)·V'   -> append/prepend word ops
    in-edge  c·V  has RC  V'·comp(c)
The verify pass replaces the reference's 1024 mutexed hash tables with a
multi-key device sort + segmented reduction; the lookup pass replaces
per-position binary search with a batched vectorized lower_bound.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from twopaco_tpu.ops import bloom, buzhash as bz, pack

U32 = jnp.uint32


@dataclass(frozen=True)
class PassConfig:
    k: int
    q: int = 5
    f: int = 25
    layout: str = "byte"
    positions_per_row: int = 2048  # P
    rows_per_batch: int = 256  # B

    @property
    def w(self) -> int:
        return pack.n_words(self.k)

    @property
    def P(self) -> int:
        return self.positions_per_row

    @property
    def B(self) -> int:
        return self.rows_per_batch


def _comp4(x: jnp.ndarray) -> jnp.ndarray:
    """Complement of an extension code; N (4) and padding stay N."""
    return jnp.where(x < 4, 3 - x, jnp.uint8(4)).astype(x.dtype)


def _strand_arrays(codes: jnp.ndarray, cfg: PassConfig):
    """codes (B, R=P+k+1) uint8 -> per-offset packed words, RC, definite.

    Offset j holds the k-mer over chars [j, j+k); vertex position i of the
    row is offset i+1 (offset 0 exists only as the i-1 "previous vertex"
    view; offset P+1 is the "next vertex" peek used by the fill gate).
    """
    k, P = cfg.k, cfg.P
    cm = jnp.where(codes < 4, codes, 0).astype(U32)
    words_all = pack.kmer_words(cm, k, P + 2)  # (B, P+2, w)
    rc_all = pack.revcomp_words(words_all, k)
    def_all = pack.window_all_definite(codes, k, P + 2)
    return words_all, rc_all, def_all


def _vertex_views(codes, cfg: PassConfig):
    k, P = cfg.k, cfg.P
    words_all, rc_all, def_all = _strand_arrays(codes, cfg)
    V = words_all[:, 1 : P + 1]
    rcV = rc_all[:, 1 : P + 1]
    defV = def_all[:, 1 : P + 1]
    prev = codes[:, 0:P]
    nxt = codes[:, k + 1 : k + 1 + P]
    return words_all, rc_all, def_all, V, rcV, defV, prev, nxt


def _pos_ok(valid: jnp.ndarray, P: int) -> jnp.ndarray:
    return jnp.arange(P, dtype=jnp.int32)[None, :] < valid[:, None]


def _within(h: jnp.ndarray, low: jnp.ndarray, high_incl: jnp.ndarray) -> jnp.ndarray:
    return (h >= low) & (h <= high_incl)


def _tables(cfg: PassConfig):
    tabs = [bz.TABLE_1, bz.TABLE_2]
    if cfg.f > 32:
        tabs += [bz.TABLE_3, bz.TABLE_4]
    return tabs


def _hash_state(codes: jnp.ndarray, cfg: PassConfig, n_out: int):
    """Per-offset strand-pair window hashes [(hf, hr), ...] per table.

    The whole-batch replacement for the reference's per-char rolling
    state (vertexrollinghash.h:54-206): two prefix-XOR scans per table,
    then O(1) per offset.
    """
    return [
        bz.window_hashes(*bz.hash_scans(codes, t), cfg.k, n_out)
        for t in _tables(cfg)
    ]


def _probe_idx(sym_hashes, cfg: PassConfig):
    e = sym_hashes  # one per table
    if cfg.f <= 32:
        return bz.probe_indices_from_sym(e[0], e[1], cfg.q, cfg.f)
    return bz.probe_indices_from_sym(
        e[0], e[1], cfg.q, cfg.f, e3=e[2], e4=e[3]
    )


def fill_indices(codes, valid, low, high_incl, cfg: PassConfig):
    """Canonical-edge Bloom indices to insert for one batch:
    -> (idx (B, P, 4, q), valid mask same shape).

    Per definite vertex position (reference vertexenumerator.h:1035-1083):
      - real out-edge V·next if next is definite, else dummy edges V·A and
        V·T (DUMMY_CHAR / REV_DUMMY_CHAR, :1012-1013,1048-1058);
      - dummy in-edges A·V and T·V when prev is non-definite (:1060-1064);
      - gated on either endpoint's canonical vertex hash in the round
        interval (:1066-1072).
    """
    k, P = cfg.k, cfg.P
    codes = pack.as_codes(codes, P + k + 1)
    tabs = _tables(cfg)
    state = _hash_state(codes, cfg, P + 2)  # offsets 0..P+1
    def_all = pack.window_all_definite(codes, k, P + 2)
    hv_all = state[0][0] + state[0][1]  # strand-symmetric vertex hash
    hv, hvn = hv_all[:, 1 : P + 1], hv_all[:, 2 : P + 2]
    defV, defVn = def_all[:, 1 : P + 1], def_all[:, 2 : P + 2]
    prev = codes[:, 0:P]
    nxt = codes[:, k + 1 : k + 1 + P]

    in_round = _within(hv, low, high_incl) | (defVn & _within(hvn, low, high_incl))
    base = _pos_ok(valid, P) & defV & in_round
    next_def = nxt < 4
    prev_def = prev < 4

    hfhr = [(hf[:, 1 : P + 1], hr[:, 1 : P + 1]) for hf, hr in state]
    c0 = jnp.where(next_def, nxt, 0)
    slot_defs = [
        (lambda t, hf, hr: bz.out_edge_sym(hf, hr, t, c0, k), base),
        (lambda t, hf, hr: bz.out_edge_sym(hf, hr, t, 3, k), base & ~next_def),
        (lambda t, hf, hr: bz.in_edge_sym(hf, hr, t, 0, k), base & ~prev_def),
        (lambda t, hf, hr: bz.in_edge_sym(hf, hr, t, 3, k), base & ~prev_def),
    ]
    idx = jnp.stack(
        [
            _probe_idx(
                [mk(t, hf, hr) for t, (hf, hr) in zip(tabs, hfhr)], cfg
            )
            for mk, _v in slot_defs
        ],
        axis=2,
    )  # (B, P, 4, q)
    val = jnp.stack([v for _mk, v in slot_defs], axis=2)  # (B, P, 4)
    val = jnp.broadcast_to(val[..., None], idx.shape)
    return idx, val


def fill_indices_block(codes, valid, low, high_incl, cfg: PassConfig):
    """(word, bit, valid) insert tuples for the vertex-blocked layout.

    Block design (this framework's answer to the reference's dominant
    random-probe loop, vertexenumerator.h:638-654): the 256-bit filter
    block is keyed by the strand-symmetric VERTEX hash, the q in-block
    bits by the strand-symmetric EDGE hash. Every real edge is written
    into BOTH in-range endpoints' blocks, dummy edges (non-ACGT
    neighbors, :1048-1064 semantics) into the real endpoint's block.
    Probing a vertex V for any of its 8 extensions then needs only
    block(V) — one contiguous 32-byte gather per position in pass2
    (8*q fewer serial gathers).

    No-false-negative argument (candidate masks must be a superset of
    true junctions): a mark probe of extension c at vertex value V must
    hit whenever edge c·V / V·c occurs in the input (that is what the
    exact verify relies on). Real edges write word(V) at every in-range
    occurrence of either endpoint with value V; dummy edges write the
    word of the vertex value they were created at, which is the value
    every same-k-mer occurrence probes. Hash symmetry makes reverse
    complements collapse to the same words and bits. Cross-phantom
    probes the global-filter reference would false-positive on simply
    miss here (fewer FPs, never fewer hits on real edges).

    Slots: 1 = V·next (or dummy V·A when next is non-definite) into
    word(V); 2 = the same real edge into word(V_next); 3 = dummy V·T
    into word(V); 4/5 = dummy A·V, T·V into word(V).
    """
    k, P = cfg.k, cfg.P
    codes = pack.as_codes(codes, P + k + 1)
    state = _hash_state(codes, cfg, P + 2)  # offsets 0..P+1
    def_all = pack.window_all_definite(codes, k, P + 2)
    hv_all = state[0][0] + state[0][1]
    hv, hvn = hv_all[:, 1 : P + 1], hv_all[:, 2 : P + 2]
    defV, defVn = def_all[:, 1 : P + 1], def_all[:, 2 : P + 2]
    prev = codes[:, 0:P]
    nxt = codes[:, k + 1 : k + 1 + P]
    pos_ok = _pos_ok(valid, P)
    base_v = pos_ok & defV & _within(hv, low, high_incl)
    next_def = nxt < 4
    prev_def = prev < 4

    t1, t2 = _tables(cfg)[0], _tables(cfg)[1]
    (hf1, hr1), (hf2, hr2) = state[0], state[1]
    s = slice(1, P + 1)
    hf1, hr1, hf2, hr2 = hf1[:, s], hr1[:, s], hf2[:, s], hr2[:, s]
    c0 = jnp.where(next_def, nxt, 0)

    def ebits(mk):
        return bloom.block_bits(
            mk(t1, hf1, hr1), mk(t2, hf2, hr2), cfg.q
        )

    b_out_c0 = ebits(lambda t, hf, hr: bz.out_edge_sym(hf, hr, t, c0, k))
    b_out_t = ebits(lambda t, hf, hr: bz.out_edge_sym(hf, hr, t, 3, k))
    b_in_a = ebits(lambda t, hf, hr: bz.in_edge_sym(hf, hr, t, 0, k))
    b_in_t = ebits(lambda t, hf, hr: bz.in_edge_sym(hf, hr, t, 3, k))

    wV = bloom.block_index(hv, cfg.f)
    wVn = bloom.block_index(hvn, cfg.f)
    word = jnp.stack([wV, wVn, wV, wV, wV], axis=2)  # (B, P, 5)
    bits = jnp.stack(
        [b_out_c0, b_out_c0, b_out_t, b_in_a, b_in_t], axis=2
    )  # (B, P, 5, q)
    val = jnp.stack(
        [
            base_v,
            pos_ok & defV & next_def & defVn
            & _within(hvn, low, high_incl),
            base_v & ~next_def,
            base_v & ~prev_def,
            base_v & ~prev_def,
        ],
        axis=2,
    )
    return word, bits, val


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def pass1_fill(filt, codes, valid, low, high_incl, *, cfg: PassConfig):
    """Single-device fill: insert this batch's edges; returns the filter."""
    if cfg.layout == "block":
        word, bits, val = fill_indices_block(
            codes, valid, low, high_incl, cfg
        )
        word, bits, val = jax.lax.optimization_barrier((word, bits, val))
        return bloom.fill_blocks(filt, word, bits, val)
    idx, val = fill_indices(codes, valid, low, high_incl, cfg)
    # Materialize the indices before the scatter, so XLA cannot fuse
    # the index computation into the scatter and serialize it (whether
    # XLA:GPU still needs the barrier is an open item in ROADMAP.md).
    idx, val = jax.lax.optimization_barrier((idx, val))
    return bloom.fill(filt, idx, val, cfg.layout)


def mark_indices(codes, valid, low, high_incl, cfg: PassConfig):
    """Probe indices for the candidate-mark pass.

    -> (idx (B, P, 8, q), base (B,P), prev (B,P), nxt (B,P)).
    Probe slots 0..3 are in-edges c·V, 4..7 out-edges V·c for c=A,C,G,T.
    """
    k, P = cfg.k, cfg.P
    codes = pack.as_codes(codes, P + k + 1)
    tabs = _tables(cfg)
    state = _hash_state(codes, cfg, P + 1)  # offsets 0..P
    def_all = pack.window_all_definite(codes, k, P + 1)
    hv = state[0][0][:, 1 : P + 1] + state[0][1][:, 1 : P + 1]
    defV = def_all[:, 1 : P + 1]
    prev = codes[:, 0:P]
    nxt = codes[:, k + 1 : k + 1 + P]
    base = _pos_ok(valid, P) & defV & _within(hv, low, high_incl)

    hfhr = [(hf[:, 1 : P + 1], hr[:, 1 : P + 1]) for hf, hr in state]
    slots = []
    for c in range(4):
        slots.append(
            _probe_idx(
                [
                    bz.in_edge_sym(hf, hr, t, c, k)
                    for t, (hf, hr) in zip(tabs, hfhr)
                ],
                cfg,
            )
        )
    for c in range(4):
        slots.append(
            _probe_idx(
                [
                    bz.out_edge_sym(hf, hr, t, c, k)
                    for t, (hf, hr) in zip(tabs, hfhr)
                ],
                cfg,
            )
        )
    return jnp.stack(slots, axis=2), base, prev, nxt


def mark_decide(hits, base, prev, nxt):
    """Candidate decision from per-slot q-AND Bloom hits (B, P, 8).

    Reference CandidateCheckingWorker semantics
    (vertexenumerator.h:633-674): inCount starts at 2 if prev is
    non-definite else 0; for c in ACGT, (c == prev) or a Bloom hit on
    in-edge c·V increments it; symmetrically for out. Candidate iff
    inCount > 1 or outCount > 1.
    """
    in_cnt = 2 * (prev >= 4).astype(jnp.int32)
    out_cnt = 2 * (nxt >= 4).astype(jnp.int32)
    for c in range(4):
        in_cnt = in_cnt + jnp.where(
            prev == c, 1, hits[:, :, c].astype(jnp.int32)
        )
        out_cnt = out_cnt + jnp.where(
            nxt == c, 1, hits[:, :, 4 + c].astype(jnp.int32)
        )
    return base & ((in_cnt > 1) | (out_cnt > 1))


def pack_mask(mask: jnp.ndarray) -> jnp.ndarray:
    """(B, P) bool -> (B, P//8) uint8, np.unpackbits-compatible (MSB
    first). Keeps host<->device mask traffic 8x smaller."""
    B, P = mask.shape
    assert P % 8 == 0
    w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    return (
        (mask.reshape(B, P // 8, 8).astype(jnp.uint8) * w)
        .sum(axis=-1, dtype=jnp.uint32)
        .astype(jnp.uint8)
    )


def unpack_mask(packed: jnp.ndarray, P: int) -> jnp.ndarray:
    """(B, P//8) uint8 -> (B, P) bool."""
    B = packed.shape[0]
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(B, -1)[:, :P] > 0


def mark_indices_block(codes, valid, low, high_incl, cfg: PassConfig):
    """Probe data for the vertex-blocked layout: ONE filter word per
    position (word (B,P)), 8 in-word masks (B,P,8) — slots 0..3
    in-edges c·V, 4..7 out-edges V·c. pass2 gathers word(V) once and
    tests the 8 masks against it, versus 8*q serial f-bit gathers in
    the flat layouts (the reference's dominant loop,
    vertexenumerator.h:633-674)."""
    k, P = cfg.k, cfg.P
    codes = pack.as_codes(codes, P + k + 1)
    state = _hash_state(codes, cfg, P + 1)
    def_all = pack.window_all_definite(codes, k, P + 1)
    hv = state[0][0][:, 1 : P + 1] + state[0][1][:, 1 : P + 1]
    defV = def_all[:, 1 : P + 1]
    prev = codes[:, 0:P]
    nxt = codes[:, k + 1 : k + 1 + P]
    base = _pos_ok(valid, P) & defV & _within(hv, low, high_incl)

    t1, t2 = _tables(cfg)[0], _tables(cfg)[1]
    (hf1, hr1), (hf2, hr2) = state[0], state[1]
    s = slice(1, P + 1)
    hf1, hr1, hf2, hr2 = hf1[:, s], hr1[:, s], hf2[:, s], hr2[:, s]

    slots = []
    for c in range(4):
        slots.append(
            bloom.block_bits(
                bz.in_edge_sym(hf1, hr1, t1, c, k),
                bz.in_edge_sym(hf2, hr2, t2, c, k),
                cfg.q,
            )
        )
    for c in range(4):
        slots.append(
            bloom.block_bits(
                bz.out_edge_sym(hf1, hr1, t1, c, k),
                bz.out_edge_sym(hf2, hr2, t2, c, k),
                cfg.q,
            )
        )
    block = bloom.block_index(hv, cfg.f)
    return block, jnp.stack(slots, axis=2), base, prev, nxt


@partial(jax.jit, static_argnames=("cfg",))
def pass2_mark(filt, codes, valid, low, high_incl, *, cfg: PassConfig):
    """Single-device mark: returns (packed mask (B, P//8), count)."""
    if cfg.layout == "block":
        block, bits, base, prev, nxt = mark_indices_block(
            codes, valid, low, high_incl, cfg
        )
        block, bits = jax.lax.optimization_barrier((block, bits))
        hits = bloom.probe_blocks(filt, block, bits)
        mask = mark_decide(hits, base, prev, nxt)
        return pack_mask(mask), jnp.sum(mask, dtype=jnp.int64)
    idx, base, prev, nxt = mark_indices(codes, valid, low, high_incl, cfg)
    # Barrier: materialize the indices, then gather (see pass1_fill).
    idx = jax.lax.optimization_barrier(idx)
    hits = bloom.probe_all(filt, idx, cfg.layout)
    mask = mark_decide(hits, base, prev, nxt)
    return pack_mask(mask), jnp.sum(mask, dtype=jnp.int64)


@partial(jax.jit, static_argnames=("cfg", "cap"))
def extract_records(codes, packed_mask, *, cfg: PassConfig, cap: int):
    """Gather candidate occurrence records from a marked batch.

    Record = (canonical k-mer words, in-extension, out-extension) in the
    canonical orientation: an RC-canonical occurrence contributes
    (comp(next), comp(prev)) (reference CandidateOccurence::Set,
    candidateoccurence.h:25-50). Returns (words (cap,w), in, out, count).
    `cap` should be a bucketed power of two so only a handful of
    executables exist across batches.
    """
    k, P, B = cfg.k, cfg.P, cfg.B
    codes = pack.as_codes(codes, P + k + 1)
    mask = unpack_mask(packed_mask, P)
    _, _, _, V, rcV, _, prev, nxt = _vertex_views(codes, cfg)
    canonV, is_rc = pack.canonical(V, rcV)
    in_code = jnp.where(is_rc, _comp4(nxt), prev)
    out_code = jnp.where(is_rc, _comp4(prev), nxt)

    flat = mask.reshape(-1)
    count = jnp.sum(flat, dtype=jnp.int32)
    (idx,) = jnp.nonzero(flat, size=cap, fill_value=B * P - 1)
    words = canonV.reshape(B * P, cfg.w)[idx]
    return words, in_code.reshape(-1)[idx], out_code.reshape(-1)[idx], count


@partial(jax.jit, static_argnames=("w",))
def verify_records(words, in_code, out_code, abundance, *, w: int):
    """Exact bifurcation test: sort by k-mer, segment-reduce extensions.

    A canonical k-mer is a junction iff
        (#distinct ACGT in-exts) + (#occurrences with N in-ext) > 1
     or the same for out-extensions
    (equivalent to the reference's first-record comparison + N counters,
    vertexenumerator.h:778-796), and its occurrence count is <= abundance
    (TrueBifurcations, vertexenumerator.h:1240). Padding rows must be
    all-0xFFFFFFFF words (sort to the end, never equal a real k-mer for
    odd k) with in=out=0.

    Returns (sorted_words, keep_first (M,), n_groups, n_junctions).
    """
    m = words.shape[0]
    cols = tuple(words[:, i] for i in range(w)) + (
        in_code.astype(jnp.int32),
        out_code.astype(jnp.int32),
    )
    sorted_cols = jax.lax.sort(cols, num_keys=w)
    sw = jnp.stack(sorted_cols[:w], axis=-1)
    sin, sout = sorted_cols[w], sorted_cols[w + 1]

    prev_w = jnp.concatenate([~sw[:1], sw[:-1]])  # first row always differs
    new_group = jnp.any(sw != prev_w, axis=-1)
    seg = jnp.cumsum(new_group.astype(jnp.int32)) - 1

    def degree(ext):
        distinct = jnp.zeros(m, dtype=jnp.int32)
        for c in range(4):
            has_c = jax.ops.segment_max(
                (ext == c).astype(jnp.int32), seg, num_segments=m
            )
            distinct = distinct + has_c
        n_ext = jax.ops.segment_sum(
            (ext == 4).astype(jnp.int32), seg, num_segments=m
        )
        return distinct + n_ext

    size = jax.ops.segment_sum(jnp.ones(m, jnp.int32), seg, num_segments=m)
    is_bif = (degree(sin) > 1) | (degree(sout) > 1)
    # sentinel-padding group: ALL words 0xFFFFFFFF (a real k-mer always
    # has a non-all-ones last word: odd k leaves zero padding bits there)
    sentinel = jnp.ones(m, dtype=bool)
    for i in range(w):
        sentinel = sentinel & (
            jax.ops.segment_max(sw[:, i], seg, num_segments=m)
            == U32(0xFFFFFFFF)
        )
    real = (size > 0) & ~sentinel
    keep_group = is_bif & (size.astype(jnp.uint64) <= abundance) & real
    n_groups = jnp.sum(real, dtype=jnp.int64)
    keep_first = new_group & keep_group[seg]
    return sw, keep_first, n_groups, jnp.sum(keep_first, dtype=jnp.int64)


INVALID_ID32 = np.int32((1 << 31) - 1)  # numpy: no backend init at import


@partial(jax.jit, static_argnames=("cfg", "cap"))
def pass4_lookup(codes, packed_mask, valid, table, *, cfg: PassConfig, cap: int):
    """Junction ids for this batch's candidate positions, compacted.

    table: (J, w) sorted canonical k-mers. id = +(rank+1) when the
    positive-strand k-mer is in the table, else -(rank+1) for its RC
    (reference BifurcationStorage::GetId, bifurcationstorage.h:100-153).
    Returns (flat_pos int32 (cap,), ids int32 (cap,), count): ascending
    flat positions (row*P + col) of found junctions only.
    """
    k, P, B = cfg.k, cfg.P, cfg.B
    codes = pack.as_codes(codes, P + k + 1)
    if table.shape[0] == 0:  # nothing to find; only stubs exist
        return (
            jnp.full(cap, B * P, jnp.int32),
            jnp.full(cap, INVALID_ID32, jnp.int32),
            jnp.int32(0),
        )
    mask = unpack_mask(packed_mask, P)
    _, _, _, V, rcV, defV, _, _ = _vertex_views(codes, cfg)
    base = _pos_ok(valid, P) & defV & mask

    # compact the CANDIDATE positions first (cap-bucketed), then binary
    # search only those: the search is log2(J) serial table gathers per
    # key, and candidates are ~2 orders of magnitude sparser than
    # positions (searching every position measured 94s of a 157s run
    # at 64 Mbases). The table is canonical, so one search of the
    # canonical k-mer replaces the old two-strand pair; the sign comes
    # from which strand was canonical (bifurcationstorage.h:100-153).
    canonV, is_rc = pack.canonical(V, rcV)
    m = B * P
    base_flat = base.reshape(-1)
    idx = jnp.arange(m, dtype=jnp.int32)
    ckeys = canonV.reshape(m, cfg.w)
    cols = jax.lax.sort(
        ((~base_flat).astype(jnp.uint32), idx)
        + tuple(ckeys[:, i] for i in range(cfg.w))
        + (is_rc.reshape(-1).astype(jnp.uint32),),
        num_keys=2,
    )
    n_cand = jnp.sum(base_flat, dtype=jnp.int32)
    pos_c = cols[1][:cap].astype(jnp.int32)
    keys_c = jnp.stack(cols[2 : 2 + cfg.w], axis=-1)[:cap]
    rc_c = cols[2 + cfg.w][:cap] > 0
    live = jnp.arange(cap, dtype=jnp.int32) < n_cand

    J = table.shape[0]
    steps = max(1, math.ceil(math.log2(max(J, 1) + 1)))
    lo = jnp.zeros(cap, jnp.int32)
    hi = jnp.full(cap, J, jnp.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        trow = table[jnp.clip(mid, 0, max(J - 1, 0))]
        go_right = pack.lex_less(trow, keys_c) & (mid < hi)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    trow = table[jnp.clip(lo, 0, max(J - 1, 0))]
    found = pack.lex_eq(trow, keys_c) & (lo < J) & live

    ids = jnp.where(rc_c, -(lo + 1), lo + 1)
    count = jnp.sum(found, dtype=jnp.int32)
    # compact found hits to the front, ascending positions preserved
    cols2 = jax.lax.sort(
        (
            (~found).astype(jnp.uint32),
            jnp.where(found, pos_c, jnp.int32(m)),
            ids,
        ),
        num_keys=2,
    )
    out_pos = cols2[1]
    out_ids = jnp.where(out_pos < m, cols2[2], INVALID_ID32)
    return out_pos, out_ids, count


@partial(jax.jit, static_argnames=("cfg", "bin_pow", "stride"))
def histogram_vertex_hashes(
    codes, valid, *, cfg: PassConfig, bin_pow: int = 16, stride: int = 1
):
    """Per-bin counts of canonical vertex hashes (multi-round splitting;
    reference InitialFilterFillerWorker, vertexenumerator.h:503-583).
    stride > 1 counts only the leading B//stride window rows (an
    unbiased sample of the pseudorandom hash stream — hash-bin mass is
    independent of genome position; counts scale by ~1/stride). Whole
    contiguous rows keep the hash scan AND the scatter small: an
    elementwise [::stride] slice measured SLOWER than exact counting
    (strided gathers cost more than the scatter saved)."""
    P = cfg.P
    codes = pack.as_codes(codes, P + cfg.k + 1)
    if stride > 1:
        codes = codes[: max(codes.shape[0] // stride, 1)]
        valid = valid[: codes.shape[0]]
    hf, hr = bz.window_hashes(
        *bz.hash_scans(codes, bz.TABLE_1), cfg.k, P + 1
    )
    hv = hf[:, 1 : P + 1] + hr[:, 1 : P + 1]
    defV = pack.window_all_definite(codes, cfg.k, P + 1)[:, 1 : P + 1]
    ok = _pos_ok(valid, P) & defV
    bins = (hv >> (32 - bin_pow)).astype(jnp.int32).reshape(-1)
    return jnp.zeros(1 << bin_pow, jnp.int32).at[bins].add(
        ok.reshape(-1).astype(jnp.int32), mode="promise_in_bounds"
    )
