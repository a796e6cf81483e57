"""Sharding: logical-axis rules (the counterpart of ``repro/sharding``).

``sharding/context.py`` (``constrain``, ``active_rules``) places XLA
sharding constraints inside traced code; it has no counterpart until the
dry run is ported.
"""
from repro_torch.sharding.rules import Fallback, MeshRules

__all__ = ["MeshRules", "Fallback"]
