"""Segmented reductions over SORTED segments, scatter-free.

jax.ops.segment_sum/max lower to an XLA scatter-add. For records already
sorted by group (the sort-join engine's invariant) the same reductions
are two log-depth associative scans — streaming vector work, with no
scatter:

  1. forward segmented inclusive scan (combine resets at group starts)
     gives prefix aggregates; the value at each group's LAST element is
     the full-group aggregate;
  2. a backward first-wins segmented scan broadcasts that value to every
     element of the group.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _seg_combine(op):
    """Associative combine on (reset_flag, value) pairs, left-to-right:
    (f_a, v_a) then (f_b, v_b) -> (f_a | f_b, v_b if f_b else op(v_a, v_b)).
    """

    def comb(a, b):
        fa, va = a
        fb, vb = b
        f = fa | fb
        v = jnp.where(fb, vb, op(va, vb))
        return f, v

    return comb


def seg_scan(x: jnp.ndarray, new_group: jnp.ndarray, op) -> jnp.ndarray:
    """Inclusive segmented scan along axis 0 (new_group resets)."""
    _f, v = jax.lax.associative_scan(
        _seg_combine(op), (new_group, x), axis=0
    )
    return v


def seg_reduce_broadcast(x: jnp.ndarray, new_group: jnp.ndarray, op) -> jnp.ndarray:
    """Full-group aggregate of x, broadcast to every element."""
    prefix = seg_scan(x, new_group, op)
    m = x.shape[0]
    last = jnp.concatenate([new_group[1:], jnp.ones(1, dtype=bool)])
    # backward first-wins scan: on the reversed array, each group's first
    # element is the original group's last (holding the full aggregate)
    first_wins = lambda va, vb: va
    rev_ng = last[::-1]
    v = seg_scan(prefix[::-1], rev_ng, first_wins)[::-1]
    return v


def seg_sum(x, new_group):
    return seg_reduce_broadcast(x, new_group, jnp.add)


def seg_max(x, new_group):
    return seg_reduce_broadcast(x, new_group, jnp.maximum)


def seg_or(x, new_group):
    return seg_reduce_broadcast(
        x.astype(jnp.int32), new_group, jnp.maximum
    ) > 0


# --- chunked variant: bounded program size for any array length ---------
#
# Chunking keeps every compiled program at a fixed CHUNK length, so the
# program does not grow with the input.
# Two host-looped passes:
#   forward:  per-chunk segmented prefix scans with a carry-in for the
#             segment spanning the chunk start;
#   backward: per-chunk broadcast of each segment's FULL aggregate (the
#             forward prefix at the segment's last element), with a
#             carry from the following chunk for the trailing segment.


@partial(jax.jit, static_argnames=("ops",))
def _fwd_chunk(xs, new_group, carries, *, ops):
    """One forward chunk for several reductions at once.

    xs: tuple of (C,) arrays; carries: tuple of scalar aggregates of the
    segment spanning the chunk start (identity for chunk 0 — combining
    the identity is a no-op, and if the chunk starts a new group the
    carry region is empty anyway). Returns (prefixes, carry_out).
    """
    before_first = jnp.cumsum(new_group.astype(jnp.int32)) == 0
    prefixes = []
    carry_out = []
    for x, op, carry in zip(xs, ops, carries):
        p = seg_scan(x, new_group, _OPS[op])
        p = jnp.where(before_first, _OPS[op](carry, p), p)
        prefixes.append(p)
        carry_out.append(p[-1])
    return tuple(prefixes), tuple(carry_out)


@partial(jax.jit, static_argnames=("ops",))
def _bwd_chunk(prefixes, new_group, next_carries, next_continues, *, ops):
    """One backward chunk: per-record full-group aggregates.

    next_carries: the full aggregate of the segment spanning this
    chunk's END (valid when next_continues). Returns (finals tuple,
    carry tuple for the previous chunk = full aggregate of the segment
    spanning this chunk's START, continues_prev bool)."""
    last = jnp.concatenate([new_group[1:], jnp.ones(1, dtype=bool)])
    # trailing segment: records with no group boundary strictly after them
    boundaries_from_here = jnp.flip(
        jnp.cumsum(jnp.flip(new_group).astype(jnp.int32))
    )
    after_last = (boundaries_from_here - new_group.astype(jnp.int32)) == 0
    finals = []
    carry_prev = []
    first_wins = lambda a, b: a
    for p, op, nc in zip(prefixes, ops, next_carries):
        z = jnp.where(last, p, _identity(op, p.dtype))
        local = seg_scan(z[::-1], last[::-1], first_wins)[::-1]
        fin = jnp.where(after_last & next_continues, nc, local)
        finals.append(fin)
        carry_prev.append(fin[0])
    continues_prev = ~new_group[0]
    return tuple(finals), tuple(carry_prev), continues_prev


def _satadd_u16x2(a, b):
    """Saturating per-halfword add on uint32 lanes (two 16-bit counters
    clamped at 0x7FFF — associative, used for >=2 tests only)."""
    lo = jnp.minimum((a & jnp.uint32(0xFFFF)) + (b & jnp.uint32(0xFFFF)),
                     jnp.uint32(0x7FFF))
    hi = jnp.minimum((a >> 16) + (b >> 16), jnp.uint32(0x7FFF))
    return lo | (hi << 16)


_OPS = {
    "add": jnp.add,
    "max": jnp.maximum,
    "or": jnp.bitwise_or,
    "satadd_u16x2": _satadd_u16x2,
}


def _identity(op: str, dtype):
    if op == "max":
        return jnp.asarray(jnp.iinfo(dtype).min, dtype)
    return jnp.asarray(0, dtype)


@jax.jit
def _cumsum_chunk(x, carry):
    s = jnp.cumsum(x)
    return s + carry, s[-1] + carry


def cumsum_chunked(x: jnp.ndarray, chunk: int) -> jnp.ndarray:
    """Inclusive prefix sum with bounded-size compiled programs."""
    m = x.shape[0]
    assert m % chunk == 0
    if m == chunk:
        return jnp.cumsum(x)
    out = []
    carry = jnp.asarray(0, x.dtype)
    for c in range(m // chunk):
        s, carry = _cumsum_chunk(x[c * chunk : (c + 1) * chunk], carry)
        out.append(s)
    return jnp.concatenate(out)


def seg_reduce_broadcast_chunked(
    xs: tuple, new_group: jnp.ndarray, ops: tuple[str, ...], chunk: int
):
    """Chunked multi-reduction: per-record full-group aggregates for each
    (x, op) pair, with every compiled program bounded to `chunk` rows.
    Array length must be a multiple of chunk (pad with a sentinel group).
    """
    m = new_group.shape[0]
    assert m % chunk == 0, "pad to a multiple of chunk"
    n_chunks = m // chunk
    if n_chunks == 1:
        finals = []
        for x, op in zip(xs, ops):
            finals.append(seg_reduce_broadcast(x, new_group, _OPS[op]))
        return tuple(finals)

    prefixes = []
    carries = tuple(_identity(op, x.dtype) for x, op in zip(xs, ops))
    for c in range(n_chunks):
        s = slice(c * chunk, (c + 1) * chunk)
        p, carries = _fwd_chunk(
            tuple(x[s] for x in xs), new_group[s], carries, ops=ops
        )
        prefixes.append(p)

    finals = [None] * n_chunks
    next_carries = tuple(p[-1] for p in prefixes[-1])
    next_continues = jnp.asarray(False)
    for c in range(n_chunks - 1, -1, -1):
        s = slice(c * chunk, (c + 1) * chunk)
        fin, carry_prev, continues_prev = _bwd_chunk(
            prefixes[c], new_group[s], next_carries, next_continues,
            ops=ops,
        )
        finals[c] = fin
        next_carries = carry_prev
        next_continues = continues_prev
    out = []
    for i in range(len(xs)):
        out.append(jnp.concatenate([finals[c][i] for c in range(n_chunks)]))
    return tuple(out)
