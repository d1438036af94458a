"""particles_ms: synchronised spans around the particle layer's sections
(emission, transport, inflow resampling, deposition, rebalance), over the
span phase's steps (ms/step)."""

SITES = tuple(f"wrf_partmc_tpu_torch.models.coupled.driver:{f}" for f in (
    "emission_step", "transport_step", "resample_inflow_particles", "surface_deposition",
    "rebalance"))


def read(run):
    if not run.span_steps:
        return None
    return 1e3 * sum(run.spans.get(s, 0.0) for s in SITES) / run.span_steps
