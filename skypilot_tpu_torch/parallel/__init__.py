"""Parallelism for the PyTorch port: mesh planning and this rank's view
of a mesh (`mesh`), the parameter layout, the tensor-parallel collectives,
the expert all_to_all and the training layouts (`sharding`), the process
group of a serve replica or a test (`group`), multi-host init from the
gang executor's env (`distributed`), ring attention over the mesh's fsdp
axis (`ring_attention`), GPipe over its pipeline axis (`pipeline`) and
analytic placement validation on H100 sizes (`validate`).
Tensor-parallel serving (MoE models too), and training over fsdp, data,
dcn, pipeline (replicated), tensor, expert (MoE experts over 'expert',
their slots exchanged by all_to_all) and context-parallel (ring) plans
(`train/trainer.py`)."""
from skypilot_tpu_torch.parallel.distributed import (
    LocalRanks, distributed_env_from_cluster, maybe_initialize_distributed)
from skypilot_tpu_torch.parallel.mesh import (MESH_AXES, MeshPlan, RankMesh,
                                              build_mesh, build_serve_mesh,
                                              mesh_axes, plan_mesh,
                                              plan_serve_mesh,
                                              validate_tensor_parallel)
from skypilot_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                  stack_stage_params,
                                                  stage_param_sharding)
from skypilot_tpu_torch.parallel.validate import (PlacementReport,
                                                  validate_placement)

__all__ = ['LocalRanks', 'MESH_AXES', 'MeshPlan', 'PlacementReport',
           'RankMesh', 'build_mesh', 'build_serve_mesh',
           'distributed_env_from_cluster', 'maybe_initialize_distributed',
           'mesh_axes', 'pipeline_apply', 'plan_mesh', 'plan_serve_mesh',
           'stack_stage_params', 'stage_param_sharding',
           'validate_placement', 'validate_tensor_parallel']
