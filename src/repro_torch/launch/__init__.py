"""Launchers: the training CLI (``python -m repro_torch.launch.train``).

The counterpart of ``repro/launch``.  The reference's mesh builders and
multi-pod dry-run wait for the node-sharded step, so nothing is exported
here.
"""

__all__ = []
