"""O(1)-per-position rolling (Buzhash/ntHash-style) window hashing.

The reference slides q cyclic hashes char-by-char
(vertexrollinghash.h:104-113, cyclichash.h:86-121) — inherently
sequential. Here the same family of hashes is computed for EVERY
position at once from prefix-XOR scans:

    H(p, n)    = XOR_{j=0..n-1} rotl(T[c_{p+j}], n-1-j)        (forward)
    G[i]       = rotr(T[c_i], i mod 32)
    S          = exclusive prefix-XOR of G
    H(p, n)    = rotl(S[p+n] ^ S[p], (p+n-1) mod 32)

    H'(p, n)   = hash of reverse-complement of the window
    G'[i]      = rotl(T[3-c_i], i mod 32)
    S'         = exclusive prefix-XOR of G'
    H'(p, n)   = rotr(S'[p+n] ^ S'[p], p mod 32)

and edge extensions are O(1) identities:

    H(W·x)     = rotl(H(W), 1) ^ T[x]        (append)
    H(x·W)     = rotl(T[x], |W|) ^ H(W)      (prepend)

Strand-symmetric values (h(E) == h(rc E)) come from combining the two
strands with '+', so no canonical-strand selection is needed anywhere in
the Bloom path. Two independent tables give (h1, h2) for
Kirsch-Mitzenmacher probe derivation. All lanes are uint32 (native vector
width); rotation amounts are per-lane vectors (mod 32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

# Frozen random 4-entry char tables (two independent hash functions).
# Generated once (numpy PCG64 seed 20160815); changing them only changes
# Bloom bit patterns, never output semantics.
_T = np.random.Generator(np.random.PCG64(20160815)).integers(
    0, 1 << 32, size=(4, 4), dtype=np.uint32
)
TABLE_1 = tuple(int(x) for x in _T[0])
TABLE_2 = tuple(int(x) for x in _T[1])
TABLE_3 = tuple(int(x) for x in _T[2])
TABLE_4 = tuple(int(x) for x in _T[3])


def rotl(x: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    s = s & 31
    return (x << s) | (x >> ((32 - s) & 31))


def rotr(x: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    s = s & 31
    return (x >> s) | (x << ((32 - s) & 31))


def _lookup(codes: jnp.ndarray, table: tuple[int, int, int, int]) -> jnp.ndarray:
    """T[c] for codes in [0,3] (N/pad may hold any value; callers mask)."""
    c = (codes & 3).astype(U32)
    t0, t1, t2, t3 = (U32(t) for t in table)
    return jnp.where(
        c < 2,
        jnp.where(c == 0, t0, t1),
        jnp.where(c == 2, t2, t3),
    )


def _comp_lookup(codes: jnp.ndarray, table) -> jnp.ndarray:
    return _lookup(3 - (codes & 3).astype(jnp.int32), table)


def hash_scans(codes: jnp.ndarray, table) -> tuple[jnp.ndarray, jnp.ndarray]:
    """codes (..., L) -> (S, S') exclusive prefix-XOR scans (..., L+1)."""
    L = codes.shape[-1]
    i = jnp.arange(L, dtype=U32)
    g_f = rotr(_lookup(codes, table), i)
    g_r = rotl(_comp_lookup(codes, table), i)
    zero = jnp.zeros(codes.shape[:-1] + (1,), U32)
    s_f = jnp.concatenate(
        [zero, jax.lax.associative_scan(jnp.bitwise_xor, g_f, axis=-1)], axis=-1
    )
    s_r = jnp.concatenate(
        [zero, jax.lax.associative_scan(jnp.bitwise_xor, g_r, axis=-1)], axis=-1
    )
    return s_f, s_r


def window_hashes(s_f, s_r, n: int, n_out: int):
    """Forward and RC-strand hashes of n-char windows at offsets
    0..n_out-1: -> (hf, hr) each (..., n_out) uint32."""
    p = jnp.arange(n_out, dtype=U32)
    d_f = s_f[..., n : n + n_out] ^ s_f[..., :n_out]
    d_r = s_r[..., n : n + n_out] ^ s_r[..., :n_out]
    hf = rotl(d_f, p + U32(n - 1))
    hr = rotr(d_r, p)
    return hf, hr


def append_hash(hf, table, c: int):
    """H(W·c) from H(W) (forward strand)."""
    return rotl(hf, U32(1)) ^ U32(table[c])


def prepend_hash(hf, table, c: int, n: int):
    """H(c·W) from H(W) for |W| = n (forward strand)."""
    rot_c = ((table[c] << (n % 32)) | (table[c] >> ((32 - n % 32) % 32))) & 0xFFFFFFFF
    return U32(rot_c) ^ hf


def _rot_const(t: int, s: int) -> int:
    s %= 32
    return ((t << s) | (t >> ((32 - s) % 32))) & 0xFFFFFFFF


def out_edge_sym(hf, hr, table, c, k: int):
    """Strand-symmetric hash of the out-edge W·c for k-char windows.

    forward: H(W·c) = rotl(H(W), 1) ^ T[c]
    rc:      H(rc(W·c)) = H(comp(c)·rc(W)) = rotl(T[comp(c)], k) ^ H(rc W)
    c may be a static int or a per-position code vector.
    """
    if isinstance(c, int):
        ef = rotl(hf, U32(1)) ^ U32(table[c])
        er = U32(_rot_const(table[3 - c], k)) ^ hr
    else:
        ef = rotl(hf, U32(1)) ^ _lookup(c, table)
        tk = tuple(_rot_const(t, k) for t in table)
        er = _comp_lookup(c, tk) ^ hr
    return ef + er


def in_edge_sym(hf, hr, table, c, k: int):
    """Strand-symmetric hash of the in-edge c·W.

    forward: H(c·W) = rotl(T[c], k) ^ H(W)
    rc:      H(rc(c·W)) = H(rc(W)·comp(c)) = rotl(H(rc W), 1) ^ T[comp(c)]
    """
    if isinstance(c, int):
        ef = U32(_rot_const(table[c], k)) ^ hf
        er = rotl(hr, U32(1)) ^ U32(table[3 - c])
    else:
        tk = tuple(_rot_const(t, k) for t in table)
        ef = _lookup(c, tk) ^ hf
        er = rotl(hr, U32(1)) ^ _comp_lookup(c, table)
    return ef + er


def probe_indices_from_sym(e1, e2, q: int, f: int, e3=None, e4=None):
    """Kirsch-Mitzenmacher probe indices from symmetric edge hashes.

    f <= 32: uint32 math from (e1, e2); f > 32: uint64 from all four.
    Returns (..., q).
    """
    if f <= 32:
        mask = U32((1 << f) - 1 if f < 32 else 0xFFFFFFFF)
        h2 = e2 | U32(1)
        return jnp.stack([(e1 + U32(j) * h2) & mask for j in range(q)], axis=-1)
    U64 = jnp.uint64
    H1 = (e3.astype(U64) << 32) | e1.astype(U64)
    H2 = ((e4.astype(U64) << 32) | e2.astype(U64)) | U64(1)
    mask = U64((1 << f) - 1)
    return jnp.stack([(H1 + U64(j) * H2) & mask for j in range(q)], axis=-1)


# --- reference (slow) implementation for tests --------------------------


def window_hash_ref(codes: np.ndarray, table) -> int:
    """Direct O(n) evaluation of the forward window hash (host)."""
    h = np.uint32(0)
    n = len(codes)
    for j, c in enumerate(codes):
        t = np.uint32(table[int(c) & 3])
        s = (n - 1 - j) % 32
        h ^= np.uint32(((int(t) << s) | (int(t) >> ((32 - s) % 32))) & 0xFFFFFFFF)
    return int(h)
