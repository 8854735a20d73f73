"""Parallelism for the PyTorch port: mesh planning and this rank's view
of a mesh (`mesh`), the parameter layout and the tensor-parallel
collectives (`sharding`), and the process group of a serve replica
(`group`).  Tensor-parallel serving only so far; the training axes
(FSDP, ring attention, pipeline, experts) are still to port."""
from skypilot_tpu_torch.parallel.mesh import (MESH_AXES, MeshPlan, RankMesh,
                                              build_mesh, build_serve_mesh,
                                              mesh_axes, plan_mesh,
                                              plan_serve_mesh,
                                              validate_tensor_parallel)

__all__ = ['MESH_AXES', 'MeshPlan', 'RankMesh', 'build_mesh',
           'build_serve_mesh', 'mesh_axes', 'plan_mesh', 'plan_serve_mesh',
           'validate_tensor_parallel']
