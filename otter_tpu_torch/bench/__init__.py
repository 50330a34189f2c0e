"""The port's benches, the counterparts of the JAX package's ``bench.py``
(``legs.py``, run as ``python -m otter_tpu_torch.bench``), ``bench_e2e.py``
(``e2e.py``) and ``tools/profile_e2e.py`` (``profile.py``). Every leg runs
on the device it is given (``"cuda"`` by default) and raises where the
JAX bench fell back to the CPU."""
