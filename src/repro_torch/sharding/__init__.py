"""Sharding: logical-axis rules and the activation constraint hook (the
counterpart of ``repro/sharding``)."""
from repro_torch.sharding.context import active_rules, constrain, sharding_context
from repro_torch.sharding.rules import Fallback, MeshRules

__all__ = ["MeshRules", "Fallback", "sharding_context", "constrain", "active_rules"]
