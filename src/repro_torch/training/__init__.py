"""Training of the port: AdamW, checkpoints in the reference's format and
the train loop (the train step is ``repro_torch.launch.steps``)."""
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            apply_updates, init_opt_state)
from repro_torch.training.train_loop import TrainResult, train

__all__ = ["load_checkpoint", "save_checkpoint", "AdamWConfig", "OptState",
           "apply_updates", "init_opt_state", "TrainResult", "train"]
