"""Seeded synthetic genome + DNBSEQ-like read simulator (SURVEY.md §2 #24).

Deterministic given a seed; used to generate oracle goldens. Scale-downs of
the acceptance configs in BASELINE.md (E. coli-like etc.).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from oracle.codec import bases_to_seq

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def revcomp_bases(b: np.ndarray) -> np.ndarray:
    return _COMP[b[::-1]]


def _qual_str(q: np.ndarray) -> str:
    """Phred+33 quality string of integer scores."""
    return (q + 33).astype(np.uint8).tobytes().decode("ascii")


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)


@dataclass
class SimRead:
    name: str
    bases: np.ndarray          # uint8 codes, 4 = N
    qual: str
    true_bases: np.ndarray     # error-free bases
    pos: int
    strand: int                # 0 fwd, 1 rev

    @property
    def seq(self) -> str:
        return bases_to_seq(self.bases)


def simulate_reads(genome: np.ndarray, n_reads: int, read_len: int,
                   error_rate: float, seed: int = 0,
                   n_rate: float = 0.0, circular: bool = False,
                   name_prefix: str = "SIM") -> list[SimRead]:
    """Single-end reads with uniform substitution errors and optional Ns.

    DNBSEQ-like fixed read length; names `{prefix}L1C001R{i:09d}`.
    """
    rng = np.random.default_rng(seed)
    G = len(genome)
    reads = []
    ext = np.concatenate([genome, genome[:read_len]]) if circular else genome
    max_start = G if circular else G - read_len
    assert max_start > 0, "genome shorter than read length"
    for i in range(n_reads):
        pos = int(rng.integers(0, max_start))
        strand = int(rng.integers(0, 2))
        true = ext[pos:pos + read_len].copy()
        if strand:
            true = revcomp_bases(true)
        b = true.copy()
        if error_rate > 0:
            errs = rng.random(read_len) < error_rate
            if errs.any():
                shifts = rng.integers(1, 4, size=read_len).astype(np.uint8)
                b = np.where(errs, (b + shifts) % 4, b).astype(np.uint8)
        if n_rate > 0:
            ns = rng.random(read_len) < n_rate
            b = np.where(ns, np.uint8(4), b).astype(np.uint8)
        qual = _qual_str(rng.integers(30, 40, read_len))
        reads.append(SimRead(f"{name_prefix}L1C001R{i:09d}", b, qual,
                             true, pos, strand))
    return reads


def make_fastq(reads: list[SimRead]) -> bytes:
    buf = io.BytesIO()
    for r in reads:
        buf.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n".encode("ascii"))
    return buf.getvalue()


def ecoli_like(seed: int = 7, genome_len: int = 20_000, coverage: int = 40,
               read_len: int = 100, error_rate: float = 0.005):
    """Small E. coli-like config (BASELINE.md config 1 scale-down)."""
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    n_reads = genome_len * coverage // read_len
    reads = simulate_reads(genome, n_reads, read_len, error_rate, seed=seed + 1)
    return genome, reads


def simulate_pairs(genome: np.ndarray, n_pairs: int, read_len: int,
                   error_rate: float, seed: int = 0,
                   insert_mean: int = 300, insert_sd: int = 30,
                   name_prefix: str = "SIM"):
    """DNBSEQ-like paired-end reads: R1 forward from the fragment start, R2
    reverse-complement from the fragment end; names `.../1` and `.../2`.
    Returns (r1 list, r2 list) of SimRead."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    r1s, r2s = [], []
    for i in range(n_pairs):
        ins = int(np.clip(rng.normal(insert_mean, insert_sd),
                          2 * read_len, G))
        pos = int(rng.integers(0, G - ins + 1))
        frag = genome[pos:pos + ins]
        mates = []
        for mate, true in ((1, frag[:read_len].copy()),
                           (2, revcomp_bases(frag[-read_len:]).copy())):
            b = true.copy()
            errs = rng.random(read_len) < error_rate
            if errs.any():
                shifts = rng.integers(1, 4, size=read_len).astype(np.uint8)
                b = np.where(errs, (b + shifts) % 4, b).astype(np.uint8)
            qual = _qual_str(rng.integers(30, 40, read_len))
            mates.append(SimRead(
                f"{name_prefix}L1C001R{i:09d}/{mate}", b, qual, true,
                pos, 0 if mate == 1 else 1))
        r1s.append(mates[0])
        r2s.append(mates[1])
    return r1s, r2s
