from .profiling import PhaseTimer, span
