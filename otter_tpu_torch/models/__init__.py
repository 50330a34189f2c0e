"""Workload pipelines on the PyTorch engine (``assemble``, ``genotype``,
``compare``, ``wgat``, ``vcf2mat``)."""
