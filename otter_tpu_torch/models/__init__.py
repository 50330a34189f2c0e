"""Workload pipelines on the PyTorch engine (``assemble``)."""
