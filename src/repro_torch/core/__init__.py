"""Host-side control plane: numpy copies of the reference's perf model,
OptPerf solvers, simulator, goodput, batch policies, controller (its
two-program path), baselines and ``JobSpec``; ``gns.local_estimates`` and
``aggregation.guard_weights`` run on torch tensors (the reference's
``repro.core`` package imports JAX)."""
