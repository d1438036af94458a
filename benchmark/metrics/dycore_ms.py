"""dycore_ms: synchronised spans around the dycore step (``solve_step``:
the ARW core, its microphysics scheme and K1's acoustic solves) and the
implicit vertical diffusion (K1), over the span phase's steps (ms/step)."""

SITES = ("wrf_partmc_tpu_torch.models.coupled.driver:solve_step",
         "wrf_partmc_tpu_torch.models.coupled.driver:vertical_diffusion_state")


def read(run):
    if not run.span_steps:
        return None
    return 1e3 * sum(run.spans.get(s, 0.0) for s in SITES) / run.span_steps
