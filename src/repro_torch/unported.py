"""Stand-ins for public names of ``repro`` whose port has not landed.

A caller of such a name gets ``NotImplementedError`` naming the ROADMAP
item that ports it, not an ``AttributeError``; the stand-in carries the
item as ``roadmap_item`` (``tests/test_torch_hygiene.py`` walks them).
"""
from __future__ import annotations


def not_ported(name: str, item: str):
    """A callable standing in for ``name`` (a function or class of the
    JAX package) that raises ``NotImplementedError`` citing ``item``."""
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to repro_torch yet (ROADMAP {item})")
    stub.__name__ = stub.__qualname__ = name.rsplit(".", 1)[-1]
    stub.__doc__ = f"Not ported yet (ROADMAP {item}); calling it raises."
    stub.roadmap_item = item
    return stub
