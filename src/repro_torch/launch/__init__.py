"""Command-line entry points, meshes and step builders of the port."""
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

__all__ = ["make_local_mesh", "make_production_mesh"]
