from .checkpoint import load_train_state, restore_opt_state, save_train_state
from .profiling import StageTimer, trace_to

__all__ = ["StageTimer", "trace_to", "load_train_state", "restore_opt_state", "save_train_state"]
