from .profiling import StageTimer

__all__ = ["StageTimer"]
