from repro_torch.train.loop import FenceInterrupt, LoopConfig, LoopResult, run_training
from repro_torch.train.step import TrainHyper, init_train_state, make_train_step

__all__ = ["FenceInterrupt", "LoopConfig", "LoopResult", "run_training",
           "TrainHyper", "init_train_state", "make_train_step"]
