"""Entry points of the port (``repro.launch``): the serving and training
loops (``launch.serve``, ``launch.train``), the meshes (``launch.mesh``),
the dry-run of one rank of each (arch x shape x mesh) cell's sharded step
on a fake process group (``launch.dryrun``) and the hill-climb's
comparisons on its counts (``launch.hillclimb``)."""

from .mesh import (MULTIPOD_SHAPE, POD_SHAPE, Mesh, current_mesh,
                   make_mesh_compat, make_production_mesh, use_mesh)

__all__ = ["Mesh", "make_production_mesh", "make_mesh_compat", "use_mesh",
           "current_mesh", "POD_SHAPE", "MULTIPOD_SHAPE"]
