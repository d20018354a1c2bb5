from repro_torch.train.checkpoint import CheckpointManager, TopologyMismatch
from repro_torch.train.loop import FenceInterrupt, LoopConfig, LoopResult, run_training
from repro_torch.train.step import (TrainHyper, init_gnn_train_state, init_train_state,
                                    make_gnn_train_step, make_prefill_step, make_serve_step,
                                    make_train_step)

__all__ = ["CheckpointManager", "TopologyMismatch", "FenceInterrupt", "LoopConfig",
           "LoopResult", "run_training", "TrainHyper", "init_gnn_train_state",
           "init_train_state", "make_gnn_train_step", "make_prefill_step",
           "make_serve_step", "make_train_step"]
