from . import embed, mesh

__all__ = ["embed", "mesh"]
