"""CPU oracle: exact, slow, unimpeachable implementations of every kmerax stage.

The reference SuperPlus binary is unobtainable (SURVEY.md §0), so this oracle
is the golden truth the device path is verified against bit-for-bit (DESIGN.md).
Everything here is pure Python/NumPy; clarity beats speed.
"""

from oracle.codec import (
    BASE_A, BASE_C, BASE_G, BASE_T, BASE_INVALID,
    seq_to_bases, bases_to_seq, kmer_int, revcomp_int, canonical_int,
    int_to_words, words_to_int, mix32, kmer_hash_words, kmer_hash_int,
    minimizer_of, bucket_of, read_kmers,
)
from oracle.count import (
    ExactSpectrum, CountingBloomOracle, histogram_of, auto_threshold,
)
from oracle.correct import correct_read, correct_reads
from oracle.assemble import build_graph, unitigs_of, assemble_fasta
from oracle.align import banded_align
