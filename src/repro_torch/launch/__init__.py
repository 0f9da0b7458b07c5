"""Launchers and launch tools of the port: the shard mesh (``mesh.py``),
the trainer (``train.py``), the open-loop serving launcher (``serve.py``),
the allocation-free specs (``specs.py``) and the dry-run (``dryrun.py``).
Only the mesh is imported here; the others are run as modules."""
from .mesh import (ShardMesh, make_mesh_for_devices, make_production_mesh,
                   mesh_device_count)

__all__ = ["ShardMesh", "make_mesh_for_devices", "make_production_mesh",
           "mesh_device_count"]
