from .profiling import PhaseTimer, trace, annotate
