"""The KDE (``models.assemble._device_kde``: K8 through
``parallel.mesh.pooled_kde_scaled``, the float64 certification in
``ops.kde``, and any float64 recompute), from the program's ``kde_device``,
``kde_certify``, ``kde_f64_fallback`` and ``kde_f64`` phases, in ms a
region of the traced window."""

PHASES = ("kde_device", "kde_certify", "kde_f64_fallback", "kde_f64")


def read(ctx):
    if not ctx.regions or not any(ctx.has_phase(p) for p in PHASES):
        return None
    return 1e3 * sum(ctx.phase(p) for p in PHASES) / ctx.regions
