"""Device-side 2-bit k-mer packing and reverse complement (pure jnp).

Data-parallel replacement for the reference's per-character rolling
state (compressedstring.h, vertexrollinghash.h): every position's packed
k-mer is computed *independently* with O(log 16 + w) vector ops per
position, so there is no sequential scan anywhere — XLA fuses the whole
thing into a handful of shift/or passes over (batch, chars) arrays.

Layout matches twopaco_tpu.dna.pack_kmers: w = ceil(k/16) uint32 words,
char 0 in the top 2 bits of word 0, left-aligned; lexicographic order on
word tuples equals string order. k odd implies w == ceil((k+1)/16), so a
(k+1)-mer edge fits the same word count as its k-mer vertex.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
# numpy scalar: a module-level jnp constant would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize ordering
_FULL = np.uint32(0xFFFFFFFF)


def n_words(k: int) -> int:
    return (k + 15) // 16


def last_word_mask(k: int) -> int:
    """Mask of the char bits in the last word (top 2r bits, r = chars)."""
    r = k - 16 * (n_words(k) - 1)
    return 0xFFFFFFFF if r == 16 else (0xFFFFFFFF << (32 - 2 * r)) & 0xFFFFFFFF


def _shift_slice(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """x[..., i] -> x[..., i+n], zero-padded at the tail (static n)."""
    if n == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n)]
    return jnp.pad(x[..., n:], pad)


def pack16(codes: jnp.ndarray) -> jnp.ndarray:
    """codes (..., L) uint32 in [0, 3] -> P16 (..., L) uint32 where
    P16[i] holds chars i..i+15 left-aligned (chars past L read as 0)."""
    p = codes.astype(U32) << 30
    for step, shift in ((1, 2), (2, 4), (4, 8), (8, 16)):
        p = p | (_shift_slice(p, step) >> shift)
    return p


def kmer_words(codes: jnp.ndarray, k: int, n_out: int) -> jnp.ndarray:
    """Packed k-mers at char offsets 0..n_out-1.

    codes: (..., L) uint32 in [0, 3] (mask N to 0 beforehand).
    Returns (..., n_out, w) uint32, word m of offset j = chars j+16m ...
    """
    w = n_words(k)
    need = n_out + 16 * w
    L = codes.shape[-1]
    if L < need:
        codes = jnp.pad(codes, [(0, 0)] * (codes.ndim - 1) + [(0, need - L)])
    p16 = pack16(codes)
    words = [_shift_slice(p16, 16 * m)[..., :n_out] for m in range(w)]
    words[-1] = words[-1] & U32(last_word_mask(k))
    return jnp.stack(words, axis=-1)


def bitrev2_32(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit groups of each uint32 lane."""
    x = ((x & U32(0x33333333)) << 2) | ((x >> 2) & U32(0x33333333))
    x = ((x & U32(0x0F0F0F0F)) << 4) | ((x >> 4) & U32(0x0F0F0F0F))
    x = ((x & U32(0x00FF00FF)) << 8) | ((x >> 8) & U32(0x00FF00FF))
    x = (x << 16) | (x >> 16)
    return x


def revcomp_words(words: jnp.ndarray, k: int) -> jnp.ndarray:
    """Reverse complement of packed k-mers (..., w) -> (..., w).

    Reverse = 2-bit-group bit-reversal of the whole 32w-bit field followed
    by a static left realignment; complement = XOR over the char bits
    (complement(code) == 3 - code == code ^ 3).
    """
    w = n_words(k)
    s = 32 * w - 2 * k  # 0 <= s < 32 (left-alignment shift)
    b = [bitrev2_32(words[..., w - 1 - m]) for m in range(w)]
    if s:
        shifted = [
            (b[m] << s) | (b[m + 1] >> (32 - s)) for m in range(w - 1)
        ] + [b[w - 1] << s]
    else:
        shifted = b
    out = [x ^ _FULL for x in shifted[:-1]]
    out.append(shifted[-1] ^ U32(last_word_mask(k)))
    return jnp.stack(out, axis=-1)


def lex_less(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic a < b over the last (word) axis; returns bool (...)."""
    w = a.shape[-1]
    lt = jnp.zeros(a.shape[:-1], dtype=bool)
    eq = jnp.ones(a.shape[:-1], dtype=bool)
    for m in range(w):
        am, bm = a[..., m], b[..., m]
        lt = lt | (eq & (am < bm))
        eq = eq & (am == bm)
    return lt


def lex_eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=-1)


def canonical(words: jnp.ndarray, rcwords: jnp.ndarray):
    """-> (canon (..., w), is_rc bool (...)): lexicographic min of the two
    strands. k odd means words != rcwords always (no 2-bit palindromes of
    odd length), so the choice is strict and deterministic — this replaces
    the reference's run-varying hash-based orientation
    (candidateoccurence.h:34, SURVEY.md §5)."""
    is_rc = lex_less(rcwords, words)
    canon = jnp.where(is_rc[..., None], rcwords, words)
    return canon, is_rc


def append_char(words: jnp.ndarray, k: int, code: jnp.ndarray) -> jnp.ndarray:
    """k-char packed -> (k+1)-char packed with `code` appended (char k).
    Requires n_words(k+1) == n_words(k) (always true for odd k)."""
    assert n_words(k + 1) == n_words(k)
    m, sh = k // 16, 30 - 2 * (k % 16)
    cols = [words[..., i] for i in range(words.shape[-1])]
    cols[m] = cols[m] | (code.astype(U32) << sh)
    return jnp.stack(cols, axis=-1)


def prepend_char(words: jnp.ndarray, k: int, code: jnp.ndarray) -> jnp.ndarray:
    """k-char packed -> (k+1)-char packed with `code` prepended (char 0)."""
    assert n_words(k + 1) == n_words(k)
    w = words.shape[-1]
    cols = [words[..., i] for i in range(w)]
    out = []
    for m in range(w - 1, 0, -1):
        out.append((cols[m] >> 2) | (cols[m - 1] << 30))
    out.append((cols[0] >> 2) | (code.astype(U32) << 30))
    out.reverse()
    return jnp.stack(out, axis=-1)


# ---- host->device transfer packing ----------------------------------
#
# Window batches travel to the device 2-bit packed plus an N bitmask
# (2.25 bits/char instead of 8): 3.6x less host-to-device traffic and
# device residency at Gbase scale, and every kernel re-packs codes into
# 16-char words anyway (pack16), so the uint8 form is purely a transfer
# format. Codes are 0..4 after FASTA validation (dna.py), so
# the round-trip is lossless.


def pack_codes_host(codes) -> tuple:
    """(B, R) uint8 host codes (0..4, 4 = N/pad) -> (packed (B,
    ceil(R/16)) uint32 2-bit chars little-first, nmask (B, ceil(R/32))
    uint32 bitmask of N chars)."""
    import numpy as np

    B, R = codes.shape
    RW = (R + 15) // 16
    c = np.zeros((B, RW * 16), np.uint32)
    c[:, :R] = codes
    isn = c >= 4
    two = np.where(isn, 0, c).reshape(B, RW, 16)
    sh = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    packed = np.bitwise_or.reduce(two << sh, axis=2).astype(np.uint32)
    NW = (R + 31) // 32
    nb = np.zeros((B, NW * 32), bool)
    nb[:, :R] = isn[:, :R]
    nmask = np.ascontiguousarray(
        np.packbits(nb.reshape(B, NW, 32), axis=2, bitorder="little")
    ).view(np.uint32)[..., 0]
    return packed, nmask


def unpack_codes(packed: jnp.ndarray, nmask: jnp.ndarray, R: int) -> jnp.ndarray:
    """Device inverse of pack_codes_host -> (B, R) uint8 codes."""
    B = packed.shape[0]
    sh = (jnp.arange(16, dtype=U32) * 2)[None, None, :]
    codes = ((packed[:, :, None] >> sh) & U32(3)).reshape(B, -1)[:, :R]
    bit = jnp.arange(32, dtype=U32)[None, None, :]
    isn = ((nmask[:, :, None] >> bit) & U32(1)).reshape(B, -1)[:, :R]
    return jnp.where(isn > 0, U32(4), codes).astype(jnp.uint8)


def as_codes(codes, R: int) -> jnp.ndarray:
    """Accept either raw (B, R) uint8 codes or the packed (packed,
    nmask) pair; kernels call this at entry so both forms work."""
    if isinstance(codes, (tuple, list)):
        return unpack_codes(codes[0], codes[1], R)
    return codes


def window_all_definite(codes: jnp.ndarray, k: int, n_out: int) -> jnp.ndarray:
    """True where chars [j, j+k) are all < 4 (ACGT), for j in 0..n_out-1.

    codes: (..., L) integer array with N/pad >= 4.
    """
    bad = (codes >= 4).astype(jnp.int32)
    cs = jnp.cumsum(bad, axis=-1)
    zero = jnp.zeros(codes.shape[:-1] + (1,), dtype=jnp.int32)
    cs0 = jnp.concatenate([zero, cs], axis=-1)  # cs0[j] = # bad in [0, j)
    L = codes.shape[-1]
    need = n_out + k
    if L < need:
        pad_n = need - L
        tail = cs0[..., -1:] + jnp.arange(1, pad_n + 1, dtype=jnp.int32)
        cs0 = jnp.concatenate([cs0, tail], axis=-1)
    return (cs0[..., k : k + n_out] - cs0[..., :n_out]) == 0
