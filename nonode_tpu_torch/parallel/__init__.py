"""Parallel training of the port: seed fleets (``fleet``)."""
