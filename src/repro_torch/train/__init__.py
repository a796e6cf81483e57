from repro_torch.train.hetero import EpochResult, HeteroTrainer

__all__ = ["HeteroTrainer", "EpochResult"]
