from .mesh import Mesh, make_mesh, mesh_pad, sharded_kernel_block, sharded_predict

__all__ = ["Mesh", "make_mesh", "mesh_pad", "sharded_kernel_block",
           "sharded_predict"]
