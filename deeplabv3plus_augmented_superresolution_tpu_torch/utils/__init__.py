from .checkpoint import load_train_state, restore_opt_state, save_train_state
from .profiling import StageTimer

__all__ = ["StageTimer", "load_train_state", "restore_opt_state", "save_train_state"]
