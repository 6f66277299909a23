"""Entry points of the port (``repro.launch``): the serving and training
loops (``launch.serve``, ``launch.train``) and the meshes
(``launch.mesh``).  The dry-run and hill-climb are still to port
(ROADMAP.md, queue 1)."""

from .mesh import (MULTIPOD_SHAPE, POD_SHAPE, Mesh, current_mesh,
                   make_mesh_compat, make_production_mesh, use_mesh)

__all__ = ["Mesh", "make_production_mesh", "make_mesh_compat", "use_mesh",
           "current_mesh", "POD_SHAPE", "MULTIPOD_SHAPE"]
