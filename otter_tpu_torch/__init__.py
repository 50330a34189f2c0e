"""otter-tpu on PyTorch and CUDA: the port of ``otter_tpu`` to an NVIDIA
H100 (Hopper, sm_90a).

The JAX package ``otter_tpu`` stays the reference; this package imports
nothing from it. Layering, as in the JAX package:

  io/       host-side feeders and writers (BGZF/BAM/BAI/FASTA/BED)
  seqs/     read/allele data model + CIGAR breakpoint projection
  ops/      exact host algorithms (alignment, KDE, hclust, POA)
  native.py the threaded C++ host library (csrc/otter_native.cpp)
  kernels/  hand-written CUDA kernels (csrc/*.cu) with plain PyTorch
            versions beside them, and the engines that route work to them
  parallel/ the pooled device KDE over a batch of regions
  models/   the batched assemble and genotype pipelines on those engines,
            compare, wgat and vcf2mat
  cli/      ``python -m otter_tpu_torch.cli.main {assemble,genotype,...}``

It never imports ``jax``.
"""

OTTER_VERSION = "v1.0"  # parity with reference src/main.cpp:9
