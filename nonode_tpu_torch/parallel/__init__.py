"""Parallel training of the port: seed fleets (``fleet``) and grid sweeps
(``sweep``)."""
