"""Oracle base/k-mer codec. Frozen conventions: DESIGN.md §§1-4.

K-mers are Python ints (arbitrary precision) — correctness over speed. The
word-layout helpers are the bridge to the device path's uint32-lane encoding.
"""

from __future__ import annotations

import numpy as np

BASE_A, BASE_C, BASE_G, BASE_T, BASE_INVALID = 0, 1, 2, 3, 4

_LUT = np.full(256, BASE_INVALID, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
                ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _LUT[ord(_ch)] = _v

_BASE_CHR = np.frombuffer(b"ACGTN", dtype=np.uint8)

M32 = 0xFFFFFFFF
HASH_SEED_1 = 0x9E3779B1
HASH_SEED_2 = 0x85EBCA77


def seq_to_bases(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (DESIGN.md §1)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def bases_to_seq(bases: np.ndarray) -> str:
    """uint8 base codes -> ASCII (4 -> 'N')."""
    b = np.minimum(np.asarray(bases, dtype=np.uint8), 4)
    return _BASE_CHR[b].tobytes().decode("ascii")


def kmer_int(bases) -> int:
    """Pack bases (first base most significant) into a Python int.

    Returns -1 if any base is invalid (>= 4).
    """
    v = 0
    for b in bases:
        b = int(b)
        if b >= 4:
            return -1
        v = (v << 2) | b
    return v


def revcomp_int(v: int, k: int) -> int:
    """Reverse-complement of a packed k-mer (DESIGN.md §2)."""
    r = 0
    for _ in range(k):
        r = (r << 2) | (3 - (v & 3))
        v >>= 2
    return r


def canonical_int(v: int, k: int) -> int:
    return min(v, revcomp_int(v, k))


def kmer_to_bases(v: int, k: int) -> np.ndarray:
    """Unpack a k-mer int back to a base array (first base most significant)."""
    out = np.empty(k, dtype=np.uint8)
    for i in range(k - 1, -1, -1):
        out[i] = v & 3
        v >>= 2
    return out


def num_words(k: int) -> int:
    return (k + 15) // 16


def int_to_words(v: int, w: int) -> list[int]:
    """Packed k-mer int -> w little-endian uint32 words (DESIGN.md §2)."""
    return [(v >> (32 * i)) & M32 for i in range(w)]


def words_to_int(words) -> int:
    v = 0
    for i, word in enumerate(words):
        v |= (int(word) & M32) << (32 * i)
    return v


def mix32(x: int) -> int:
    """murmur3 fmix32 (DESIGN.md §3), wrapping uint32 arithmetic."""
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x


def kmer_hash_words(words, seed: int) -> int:
    """h = mix32(seed); for w in words: h = mix32(h ^ w)  (DESIGN.md §3)."""
    h = mix32(seed)
    for w in words:
        h = mix32(h ^ (int(w) & M32))
    return h


def kmer_hash_int(v: int, k: int, seed: int) -> int:
    return kmer_hash_words(int_to_words(v, num_words(k)), seed)


def minimizer_of(canon: int, k: int, m: int) -> int:
    """Minimizer of the canonical-orientation bases (DESIGN.md §4).

    min over j of mix32(m-mer value at offset j); m <= 15.
    """
    assert 0 < m <= 15 and m < k
    bases = kmer_to_bases(canon, k)
    mmask = (1 << (2 * m)) - 1
    v = 0
    best = 1 << 33
    for j in range(k):
        v = ((v << 2) | int(bases[j])) & mmask
        if j >= m - 1:
            h = mix32(v)
            if h < best:
                best = h
    return best


def bucket_of(canon: int, k: int, m: int, num_buckets: int) -> int:
    return minimizer_of(canon, k, m) % num_buckets


def read_kmers(bases: np.ndarray, k: int):
    """Yield (position, canonical kmer int) for each VALID k-mer of a read."""
    n = len(bases)
    for j in range(n - k + 1):
        v = kmer_int(bases[j:j + k])
        if v >= 0:
            yield j, canonical_int(v, k)
