"""Device layout of the port's sharded serving tier (``mesh.py``)."""
from .mesh import ShardMesh, make_mesh_for_devices, mesh_device_count

__all__ = ["ShardMesh", "make_mesh_for_devices", "mesh_device_count"]
