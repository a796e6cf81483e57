from repro_torch.data.pipeline import (
    BoundedStream,
    HeteroBatchPartitioner,
    NodeBatch,
    SyntheticLM,
)

__all__ = ["SyntheticLM", "HeteroBatchPartitioner", "NodeBatch", "BoundedStream"]
