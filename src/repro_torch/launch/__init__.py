"""Entry points of the port (``repro.launch``): the serving and training
drivers (the mesh, dry-run and hill-climb come with the distributed
slice)."""
