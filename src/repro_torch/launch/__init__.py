"""Launchers: the node mesh and the training CLI (``python -m
repro_torch.launch.train``).

The counterpart of ``repro/launch``.  The reference's production meshes
and rule assembly (``make_production_mesh``, ``make_rules``) and its
multi-pod dry run wait for the dry run's port.
"""
from repro_torch.launch.mesh import make_node_mesh, node_shard_count

__all__ = ["make_node_mesh", "node_shard_count"]
