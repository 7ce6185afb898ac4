from repro_torch.training import checkpoint, federated, optimizer, trainer
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.trainer import TrainConfig, make_train_step

__all__ = ["OptimizerConfig", "TrainConfig", "checkpoint", "federated",
           "make_train_step", "optimizer", "trainer"]
