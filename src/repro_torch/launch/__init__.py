"""Launchers: the node mesh, the production meshes, the training CLI
(``python -m repro_torch.launch.train``) and the dry run (``python -m
repro_torch.launch.dryrun``).

The counterpart of ``repro/launch``.
"""
from repro_torch.launch.mesh import make_node_mesh, node_shard_count

__all__ = ["make_node_mesh", "node_shard_count"]
