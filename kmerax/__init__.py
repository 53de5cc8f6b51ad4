"""kmerax — short-read k-mer counting, error correction & assembly on the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
MGI-tech-bioinformatics/SuperPlus (see SURVEY.md; the reference tree is
unavailable, SURVEY.md §0, so algorithm semantics are frozen in DESIGN.md and
verified bit-for-bit against the CPU oracle in `oracle/`).

Layers (SURVEY.md §1):
  core/      2-bit codec, k-mer extraction, minimizers, hashing   (L0)
  io/        FASTQ/FASTA streaming, batching                      (L1)
  dist/      device mesh + collectives                            (L2)
  spectrum/  exact + counting-Bloom k-mer spectra                 (L3)
  ops/       correction + alignment kernels                       (L4)
  graph/     de-Bruijn unitig construction                        (L4)
  pipeline/  stage orchestration, checkpoint/resume               (L5)
  cli        command-line front end                               (L6)
"""

__version__ = "0.1.0"

from kmerax.config import KmeraxConfig
