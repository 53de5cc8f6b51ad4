"""2-bit DNA codec over uint32 lane vectors (SURVEY.md §2 #1).

Device int64 is slow or absent, so a k-mer is W = ceil(k/16) little-endian
uint32 words (`words[..., 0]` = least-significant 32 bits); k=31 -> 2 words,
k=63 -> 4. Conventions frozen in DESIGN.md §§1-2; bit-exact vs oracle/codec.py.

All functions are jit-safe pure jnp ops; k is static.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

BASE_INVALID = 4

_LUT = np.full(256, BASE_INVALID, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
                ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _LUT[ord(_ch)] = _v
_BASE_CHR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def num_words(k: int) -> int:
    return (k + 15) // 16


def seq_bytes_to_bases(buf: np.ndarray) -> np.ndarray:
    """Host-side: ASCII uint8 array -> base codes (vectorized LUT)."""
    return _LUT[buf]


def bases_to_seq_bytes(bases: np.ndarray) -> np.ndarray:
    """Host-side: base codes -> ASCII uint8 ('N' for 4)."""
    return _BASE_CHR[np.minimum(bases, 4)]


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def _reverse_pairs_u32(w: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit groups within each uint32."""
    w = ((w & _u32(0x33333333)) << 2) | ((w >> 2) & _u32(0x33333333))
    w = ((w & _u32(0x0F0F0F0F)) << 4) | ((w >> 4) & _u32(0x0F0F0F0F))
    w = ((w & _u32(0x00FF00FF)) << 8) | ((w >> 8) & _u32(0x00FF00FF))
    w = (w << 16) | (w >> 16)
    return w


def revcomp_words(words: jnp.ndarray, k: int) -> jnp.ndarray:
    """Reverse-complement of packed k-mers; words shape (..., W)."""
    w = num_words(k)
    assert words.shape[-1] == w
    x = words ^ _u32(0xFFFFFFFF)          # complement: b -> 3-b == b^3
    x = _reverse_pairs_u32(x)             # reverse 2-bit groups within words
    x = x[..., ::-1]                      # reverse word order
    s = 32 * w - 2 * k                    # 0 <= s < 32 by construction
    if s == 0:
        return x
    hi = jnp.concatenate(
        [x[..., 1:], jnp.zeros_like(x[..., :1])], axis=-1)
    return (x >> s) | (hi << (32 - s))


def words_less(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unsigned big-integer a < b over little-endian word axis."""
    lt = jnp.zeros(a.shape[:-1], dtype=bool)
    for i in range(a.shape[-1]):          # low word first; high words dominate
        lt = (a[..., i] < b[..., i]) | ((a[..., i] == b[..., i]) & lt)
    return lt


def words_equal(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=-1)


def words_le(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return words_less(a, b) | words_equal(a, b)


def canonical_words(words: jnp.ndarray, k: int):
    """(canonical words, is_forward) — min(fwd, revcomp) per DESIGN.md §2."""
    rc = revcomp_words(words, k)
    is_fwd = words_le(words, rc)
    canon = jnp.where(is_fwd[..., None], words, rc)
    return canon, is_fwd
