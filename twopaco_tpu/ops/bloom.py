"""Device-resident Bloom filter: functional fill (scatter) / probe (gather).

Data-parallel replacement for the reference's atomic fetch_or bit array
(concurrentbitvector.cpp:31-37). Two layouts:

  - 'byte': one uint8 per Bloom slot. Fill is a plain scatter-max (all
    writes are 1, so it is order-independent and deterministic); probe is
    a byte gather. Simple and fast; 2^f bytes of HBM.
  - 'bit':  one uint32 word per 32 slots (8x denser, the reference's
    layout). There is no scatter-OR primitive, so fill is made
    deterministic and race-free by construction: sort the (word, bit)
    pairs, drop duplicates, OR each word's bits with a segmented sum of
    distinct powers of two, then scatter-assign the unique words. The
    sort also coalesces the memory traffic — random single-bit writes
    become mostly-sequential word updates.

Both are pure functions: fill returns the new filter array (donate the
argument under jit for in-place HBM update).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

U32 = jnp.uint32

# Single-device layout caps: this code indexes the filter with int32
# (see _index_dtype), so a layout stops where int32 element indexing
# does. Lifting them is ROADMAP Reach D.
BYTE_LAYOUT_MAX_F = 30  # 1 GiB of uint8 slots; 2^31 slots overflow int32
BIT_LAYOUT_MAX_F = 35  # 4 GiB of bits; word index (2^30) must fit int32
# (f=36 would need 2^31 words — beyond int32 indexing and the fill
# sentinel scheme; shard across devices instead)


def choose_layout_slots(
    slots: int, byte_budget_bytes: int = 1 << 31
) -> str:
    """Pick a layout for a filter (shard) of `slots` Bloom slots."""
    if slots <= byte_budget_bytes and slots <= (1 << BYTE_LAYOUT_MAX_F):
        return "byte"
    if slots <= (1 << BIT_LAYOUT_MAX_F):
        return "bit"
    raise ValueError(
        f"Bloom filter of {slots} slots per device exceeds the "
        f"supported layouts (max 2^{BIT_LAYOUT_MAX_F} slots = 4 GiB of "
        "bits per device). Use --tpu-engine dist-bloom to shard the "
        "filter across a device mesh (each device then owns "
        "2^f/n_devices slots), spread it over more devices, or lower "
        "-f/--filtermemory. The default sort engine does not allocate "
        "a filter and accepts any -f."
    )


def choose_layout(f: int, byte_budget_bytes: int = 1 << 31) -> str:
    return choose_layout_slots(1 << f, byte_budget_bytes)


def check_layout_slots(slots: int, layout: str) -> None:
    """Validate an EXPLICITLY-chosen layout against its capacity so the
    user gets the actionable message, not a trace-time OverflowError
    from the int32 fill sentinel deep in _fill_word_bits."""
    max_f = BYTE_LAYOUT_MAX_F if layout == "byte" else BIT_LAYOUT_MAX_F
    if slots > (1 << max_f):
        raise ValueError(
            f"'{layout}' Bloom layout supports at most 2^{max_f} slots "
            f"per device (got {slots}). Use --tpu-engine dist-bloom to "
            "shard the filter across a device mesh, lower "
            "-f/--filtermemory, or use the default sort engine (no "
            "filter, any -f)."
        )


def make_filter(f: int, layout: str) -> jnp.ndarray:
    if layout == "byte":
        return jnp.zeros(1 << f, dtype=jnp.uint8)
    elif layout in ("bit", "block"):
        # block: same 2^(f-5) u32 words, organized as 2^(f-8) 256-bit
        # blocks keyed by vertex hash (needs at least one full block)
        if layout == "block" and f < 8:
            raise ValueError("block layout needs f >= 8")
        return jnp.zeros(1 << max(f - 5, 0), dtype=U32)
    raise ValueError(layout)


def fill(filt: jnp.ndarray, idx: jnp.ndarray, valid: jnp.ndarray, layout: str) -> jnp.ndarray:
    """Set Bloom slots idx (any shape) where valid; returns new filter."""
    idx = idx.reshape(-1)
    valid = valid.reshape(-1)
    if layout == "byte":
        safe = jnp.where(valid, idx, 0).astype(_index_dtype(filt.shape[0]))
        upd = valid.astype(jnp.uint8)
        return filt.at[safe].max(upd, mode="promise_in_bounds")
    return _fill_bits(filt, idx, valid)


def _index_dtype(n: int):
    """int32 whenever the array is addressable with it: narrower index
    math and index arrays (whether int64 costs anything on the GPU is
    an open item in ROADMAP.md). At exactly n = 2^31 (the f=31 byte layout) jax's index
    normalization must hold the SIZE as a constant of the index dtype,
    so int32 overflows at trace time — slot indices are non-negative,
    so uint32 covers up to 2^32 slots without int64 emulation."""
    if n < (1 << 31):
        return jnp.int32
    if n <= (1 << 32):
        return jnp.uint32
    return jnp.int64


def _fill_bits(filt: jnp.ndarray, idx: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    word = (idx >> 5).astype(jnp.int32)
    bit = (idx & 31).astype(jnp.int32)
    return _fill_word_bits(filt, word, bit, valid)


def _fill_word_bits(
    filt: jnp.ndarray, word: jnp.ndarray, bit: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Race-free OR of single bits into u32 words: sort the (word, bit)
    pairs, drop duplicates, segment-sum distinct powers of two, scatter
    the merged words. Shared by the 'bit' layout (word/bit derived from
    a flat slot index) and the 'block' layout (word = vertex hash, bit =
    edge hash — see fill_blocks)."""
    # invalid entries sort to the end and scatter out of bounds (dropped);
    # filt.shape[0] <= 2^30 (BIT_LAYOUT_MAX_F) so the sentinel is always
    # a valid int32 strictly above every real word index
    oob = jnp.int32(filt.shape[0])
    word = jnp.where(valid, word, oob)
    word, bit = jax.lax.sort((word, bit), num_keys=2)
    prev_word = jnp.concatenate([jnp.full(1, -1, jnp.int32), word[:-1]])
    prev_bit = jnp.concatenate([jnp.full(1, -1, jnp.int32), bit[:-1]])
    uniq = (word != prev_word) | (bit != prev_bit)
    new_word = word != prev_word
    seg = jnp.cumsum(new_word.astype(jnp.int32)) - 1
    m = word.shape[0]
    masks = jnp.where(uniq, U32(1) << bit.astype(U32), U32(0))
    or_mask = jax.ops.segment_sum(masks, seg, num_segments=m)  # distinct bits -> OR
    seg_word = jax.ops.segment_max(word, seg, num_segments=m)
    gather_word = jnp.clip(seg_word, 0, filt.shape[0] - 1)
    merged = filt[gather_word] | or_mask
    # Sentinel segments (invalid entries) and empty segments (segment_max
    # identity = int32 min) must not scatter. mode='drop' only drops
    # positive out-of-range indices (negatives wrap, numpy-style), so
    # redirect both cases to a positive out-of-range index.
    n = jnp.int32(filt.shape[0])
    bad = (seg_word >= n) | (seg_word < 0)
    seg_word = jnp.where(bad, n, seg_word)
    return filt.at[seg_word].set(merged, mode="drop")


# vertex-blocked layout: 256-bit blocks of 8 consecutive u32. A block
# must be wide enough that one vertex's incident-edge bits (deg*q,
# deg ~ 2-8) stay a small fraction of it: a 32-bit block measured 33%
# candidate-mark FPR on the 64 Mbase bench (deg*q/32 load), 256 bits
# put the load back at the ~1% of the flat layouts. The 32-byte block
# gather costs the same as a 4-byte one at HBM access granularity.
BLOCK_WORDS = 8
BLOCK_BITS = 32 * BLOCK_WORDS


def fill_blocks(
    filt: jnp.ndarray,
    block: jnp.ndarray,
    bit: jnp.ndarray,
    valid: jnp.ndarray,
) -> jnp.ndarray:
    """Vertex-blocked fill: set `bit` (..., q) in [0, 256) of 256-bit
    `block` (...) where valid (...). block = f-8-bit slice of the
    strand-symmetric VERTEX hash of an edge endpoint; bit = in-block
    positions derived from the strand-symmetric EDGE hash. Because the
    block is keyed by the endpoint vertex, the mark pass tests all 8
    edge extensions of a position with ONE contiguous 32-byte gather
    (probe_blocks) instead of 8*q scattered f-bit gathers.
    Every real edge writes both in-range endpoints' blocks, so any
    probe the reference design guarantees to hit still hits (no false
    negatives; see kernels.fill_indices_block)."""
    q = bit.shape[-1]
    word = block[..., None] * jnp.int32(BLOCK_WORDS) + (
        bit.astype(jnp.int32) >> 5
    )
    valid_q = jnp.broadcast_to(valid[..., None], valid.shape + (q,))
    return _fill_word_bits(
        filt,
        word.reshape(-1),
        (bit.astype(jnp.int32) & 31).reshape(-1),
        valid_q.reshape(-1),
    )


def probe_blocks(
    filt: jnp.ndarray, block: jnp.ndarray, bits: jnp.ndarray
) -> jnp.ndarray:
    """Gather each position's 8-word block once, test bits (..., S, q):
    True where ALL q bits of a slot are present. The in-block word
    select is a one-hot sum (vector compares are cheap next to gathers).
    Slots/bits unroll as Python loops over (...)-shaped temporaries,
    so no (..., S, q, 8) broadcast is ever materialized. The block
    gather is 8 flat word gathers at consecutive addresses
    (base+0..base+7, one 32-byte line), with the index arrays
    materialized behind an optimization_barrier first so that index
    math is not fused into the gathers (see kernels.pass1_fill)."""
    base = block.astype(jnp.int32) * jnp.int32(BLOCK_WORDS)
    idxs = jax.lax.optimization_barrier(
        tuple(base + jnp.int32(kk) for kk in range(BLOCK_WORDS))
    )
    gw = [filt[i] for i in idxs]  # 8 flat (...)-shaped gathers
    outs = []
    for s in range(bits.shape[-2]):
        hit = None
        for j in range(bits.shape[-1]):
            bj = bits[..., s, j]
            w = (bj >> U32(5)).astype(jnp.int32)
            b = bj & U32(31)
            word = jnp.zeros(w.shape, U32)
            for k in range(BLOCK_WORDS):
                word = word | jnp.where(w == k, gw[k], U32(0))
            h = ((word >> b) & U32(1)) > 0
            hit = h if hit is None else (hit & h)
        outs.append(hit)
    return jnp.stack(outs, axis=-1)  # (..., S)


def block_index(hv: jnp.ndarray, f: int) -> jnp.ndarray:
    """Block index of a vertex: low f-8 bits of the symmetric hash (the
    filter has 2^(f-8) blocks = 2^f bloom bits, same HBM as 'bit')."""
    return (hv & U32((1 << max(f - 8, 0)) - 1)).astype(jnp.int32)


def block_bits(e1: jnp.ndarray, e2: jnp.ndarray, q: int) -> jnp.ndarray:
    """q distinct in-block bit positions from the symmetric edge hash:
    (e1 + j*(e2|1)) mod 256 — the odd multiplier makes j*(e2|1)
    distinct mod 256 for j < 256, so a slot always tests exactly q
    bits."""
    h2 = e2 | U32(1)
    return jnp.stack(
        [((e1 + U32(j) * h2) & U32(BLOCK_BITS - 1)) for j in range(q)],
        axis=-1,
    )


def probe(filt: jnp.ndarray, idx: jnp.ndarray, layout: str) -> jnp.ndarray:
    """Test Bloom slots; True where the bit is set. idx any shape."""
    if layout == "byte":
        return filt[idx.astype(_index_dtype(filt.shape[0]))] > 0
    word = (idx >> 5).astype(jnp.int32)
    bit = (idx & 31).astype(U32)
    return ((filt[word] >> bit) & U32(1)) > 0


def probe_all(filt: jnp.ndarray, idx_q: jnp.ndarray, layout: str) -> jnp.ndarray:
    """AND of q probes along the last axis: (..., q) -> (...)."""
    return jnp.all(probe(filt, idx_q, layout), axis=-1)
