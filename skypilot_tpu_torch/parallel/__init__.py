"""Parallelism for the PyTorch port: mesh planning and this rank's view
of a mesh (`mesh`), the parameter layout, the tensor-parallel collectives
and the training layouts (`sharding`), the process group of a serve
replica or a test (`group`), multi-host init from the gang executor's env
(`distributed`), and ring attention over the mesh's fsdp axis
(`ring_attention`).  Tensor-parallel serving, and training over fsdp,
data, dcn, tensor and context-parallel (ring) plans
(`train/trainer.py`); the pipeline axis, the expert-parallel MoE layout
and placement validation are still to port."""
from skypilot_tpu_torch.parallel.distributed import (
    LocalRanks, distributed_env_from_cluster, maybe_initialize_distributed)
from skypilot_tpu_torch.parallel.mesh import (MESH_AXES, MeshPlan, RankMesh,
                                              build_mesh, build_serve_mesh,
                                              mesh_axes, plan_mesh,
                                              plan_serve_mesh,
                                              validate_tensor_parallel)

__all__ = ['LocalRanks', 'MESH_AXES', 'MeshPlan', 'RankMesh', 'build_mesh',
           'build_serve_mesh', 'distributed_env_from_cluster',
           'maybe_initialize_distributed', 'mesh_axes', 'plan_mesh',
           'plan_serve_mesh', 'validate_tensor_parallel']
