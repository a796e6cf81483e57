"""Host-side control plane: numpy copies of the reference's perf model and
OptPerf solver (the reference's ``repro.core`` package imports JAX)."""
