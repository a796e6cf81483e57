"""Shared example bootstrap: make ``repro_torch`` importable when an example
is run straight from a checkout (``python examples_torch/<name>.py``)
without installing the package or exporting PYTHONPATH."""
import os
import sys

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
