"""A picklable stand-in for ``torch_geometric.data.Data`` (the port's copy of
the part of nonode_tpu/compat/ref_stubs.py that reading a reference
artifact needs).

The reference saves its trajectory artifact as a torch pickle of
``Data.from_dict(trajectories)`` (main.py:190). ``install()`` registers
``torch_geometric`` and ``torch_geometric.data`` modules holding ``Data``
when the real package is absent, so that ``torch.load`` of such a pickle
finds its class; ``analysis.results.load_reference_results`` calls it.
"""

from __future__ import annotations

import sys
import types


class Data:
    """Picklable stand-in for torch_geometric.data.Data as the reference uses
    it: a named bag of tensors (main.py:190 ``Data.from_dict(trajectories)``)."""

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)

    def to_dict(self):
        return dict(self.__dict__)

    def __repr__(self):
        return f"Data({', '.join(self.__dict__)})"


def install():
    """Register ``torch_geometric`` and ``torch_geometric.data`` with the
    stand-in ``Data`` unless they exist; a module registered bare gets
    ``Data`` added. Idempotent."""
    tg = sys.modules.setdefault("torch_geometric",
                                types.ModuleType("torch_geometric"))
    tg_data = sys.modules.setdefault("torch_geometric.data",
                                     types.ModuleType("torch_geometric.data"))
    if not hasattr(tg_data, "Data"):
        tg_data.Data = Data
    tg.data = tg_data
