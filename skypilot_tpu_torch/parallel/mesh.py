"""Device meshes for the PyTorch port: the JAX package's planners, and
this rank's view of a serve mesh over a `torch.distributed` group.

Axes as in `skypilot_tpu/parallel/mesh.py` (outermost first): ``dcn``,
``pipeline``, ``data``, ``fsdp``, ``expert``, ``tensor``.  `MeshPlan`,
`plan_mesh`, `validate_tensor_parallel` and `plan_serve_mesh` are plain
Python inside a JAX module there, so this package keeps its own copies,
verbatim (a test holds them to the originals).

PyTorch has no single controller: a mesh is one process per device,
joined in one process group (`parallel/group.py` spawns and joins
them), and each rank builds its own view with `build_mesh` /
`build_serve_mesh`: a `DeviceMesh` named by `MESH_AXES` over every rank
of the group, the rank's device, the backend of its collectives, and a
gloo group over the same ranks for the host-side control messages (CPU
tensors), whatever the backend of the device collectives.

Devices: by default `cuda:0 .. cuda:N-1` over NCCL, one card per rank;
with fewer CUDA devices than ranks the mesh is refused, unless the
group spans SKYTPU_NUM_NODES hosts of this host's card count
(`parallel/distributed.py`): rank r then runs on its host's card
r % cards.  NCCL cannot put
two ranks on one card: only an explicit device list with a repeated
card and `backend='gloo'` does that (gloo stages CUDA tensors through
the host; a correctness setting, not a fast one).  CPU devices mean
gloo on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

MESH_AXES = ('dcn', 'pipeline', 'data', 'fsdp', 'expert', 'tensor')


def mesh_axes() -> Tuple[str, ...]:
    return MESH_AXES


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Chosen parallelism degrees; product must equal device count.
    (Field order keeps the historical positional form
    MeshPlan(data, fsdp, tensor); expert/pipeline are keyword-new.)"""
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    expert: int = 1
    pipeline: int = 1
    dcn: int = 1

    @property
    def num_devices(self) -> int:
        return (self.data * self.fsdp * self.tensor * self.expert *
                self.pipeline * self.dcn)

    def validate(self, n_devices: int) -> None:
        if self.num_devices != n_devices:
            raise ValueError(
                f'Mesh plan {self} uses {self.num_devices} devices, but '
                f'{n_devices} are available.')


def plan_mesh(n_devices: int,
              data: Optional[int] = None,
              fsdp: Optional[int] = None,
              tensor: Optional[int] = None,
              expert: Optional[int] = None,
              pipeline: Optional[int] = None,
              dcn: Optional[int] = None) -> MeshPlan:
    """Fill in unset axis sizes.

    Policy (matches common TPU practice): tensor/expert/pipeline
    parallelism only when asked; remaining devices default to ``fsdp``,
    which composes with context parallelism and keeps HBM headroom for
    large models.  `data` absorbs what the caller pins.  ``dcn`` defaults
    to SKYTPU_NUM_SLICES (injected per host by the gang executor on
    multislice clusters) so inter-slice data parallelism is automatic;
    the per-slice axes then divide the per-slice devices.
    """
    if dcn is None:
        # On a multislice cluster the gang executor injects
        # SKYTPU_NUM_SLICES (parallel/distributed.py); default the dcn
        # axis to it so plan_mesh(jax.device_count()) does the right
        # thing without the user threading the slice count through.
        env_slices = int(os.environ.get('SKYTPU_NUM_SLICES', '1'))
        if env_slices > 1:
            if n_devices % env_slices != 0:
                raise ValueError(
                    f'SKYTPU_NUM_SLICES={env_slices} does not divide the '
                    f'device count {n_devices}; pass dcn= explicitly.')
            dcn = env_slices
    known = {'data': data, 'fsdp': fsdp, 'tensor': tensor,
             'expert': expert, 'pipeline': pipeline, 'dcn': dcn}
    fixed = {k: v for k, v in known.items() if v is not None}
    prod = math.prod(fixed.values()) if fixed else 1
    if n_devices % max(prod, 1) != 0:
        raise ValueError(
            f'Pinned axes {fixed} do not divide device count {n_devices}.')
    free = n_devices // max(prod, 1)
    if 'fsdp' not in fixed:
        fixed['fsdp'] = fixed.get('fsdp', 1) * free
        free = 1
    elif 'data' not in fixed:
        fixed['data'] = fixed.get('data', 1) * free
        free = 1
    if free != 1:
        # All axes pinned but don't multiply out — validate() catches.
        pass
    plan = MeshPlan(data=fixed.get('data', 1),
                    fsdp=fixed.get('fsdp', 1),
                    tensor=fixed.get('tensor', 1),
                    expert=fixed.get('expert', 1),
                    pipeline=fixed.get('pipeline', 1),
                    dcn=fixed.get('dcn', 1))
    plan.validate(n_devices)
    return plan


def validate_tensor_parallel(tensor: int,
                             n_heads: Optional[int] = None,
                             n_kv_heads: Optional[int] = None) -> None:
    """Reject a tensor degree the model's head layout cannot shard.

    Tensor parallelism splits attention over heads: `tensor` must divide
    `n_heads` (query heads) and, under GQA, `n_kv_heads` as well — the
    per-layer KV cache shards over kv heads, and a non-dividing degree
    would leave some chip with a fractional head.  (Replicating KV under
    an over-wide degree is possible but silently wastes the HBM the user
    went multi-chip to get; make them pick a degree that fits.)
    """
    if n_heads is not None and n_heads % tensor != 0:
        raise ValueError(
            f'tensor={tensor} does not divide n_heads={n_heads}; '
            f'attention shards over query heads')
    if n_kv_heads is not None and n_kv_heads % tensor != 0:
        raise ValueError(
            f'tensor={tensor} does not divide n_kv_heads={n_kv_heads} '
            f'(GQA): the KV cache shards over kv heads — pick a tensor '
            f'degree that divides both head counts')


def plan_serve_mesh(n_devices: int,
                    tensor: Optional[int] = None,
                    n_heads: Optional[int] = None,
                    n_kv_heads: Optional[int] = None) -> MeshPlan:
    """Mesh plan for a SERVE replica: tensor parallelism only.

    Unlike `plan_mesh` (training), leftover devices go to `data` (pure
    replication for the decode batch) rather than fsdp, `tensor`
    defaults to the whole device set (decode is bandwidth-bound — every
    chip's HBM should hold a weight shard), and the `dcn` axis is NEVER
    inherited from SKYTPU_NUM_SLICES: a serve replica is per-slice by
    construction (the service load balancer, not DCN collectives,
    spreads traffic across slices).
    """
    tensor = int(n_devices if tensor is None else tensor)
    if tensor < 1 or n_devices % tensor != 0:
        raise ValueError(
            f'tensor={tensor} must be >= 1 and divide the serve '
            f'replica\'s device count {n_devices}')
    validate_tensor_parallel(tensor, n_heads=n_heads, n_kv_heads=n_kv_heads)
    return MeshPlan(data=n_devices // tensor, tensor=tensor)


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """This rank's view of a mesh: `device_mesh` over every rank of the
    process group (dims named by `MESH_AXES`), the rank's `device`, the
    `backend` of the device collectives ('nccl' or 'gloo') and
    `control_group`, a gloo group over the same ranks for CPU tensors."""
    device_mesh: Any
    device: torch.device
    backend: str
    control_group: Any
    _derived: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                                 repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape` reads."""
        return dict(zip(MESH_AXES, self.device_mesh.mesh.shape))

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    @property
    def rank(self) -> int:
        """This process's rank in the group (0 takes the requests)."""
        return dist.get_rank()

    def group(self, axis: str = 'tensor'):
        """The process group along `axis` that holds this rank."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str = 'tensor') -> int:
        """This rank's index along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    def train_mesh(self):
        """The DeviceMesh of training, built once (every rank together):
        dims ('tensor', 'replicate', 'shard') over the same ranks, where
        'shard' is the 'fsdp' axis and 'replicate' flattens ('dcn',
        'pipeline', 'data', 'expert').  FSDP2 shards over its
        ('replicate', 'shard') dims at this rank's tensor coordinate
        (HSDP, `fsdp_mesh`); a checkpoint's global tensors live on all
        three dims."""
        if 'train' not in self._derived:
            from torch.distributed.device_mesh import DeviceMesh
            shape = self.shape
            ranks = self.device_mesh.mesh.permute(5, 0, 1, 2, 4, 3).reshape(
                shape['tensor'], -1, shape['fsdp'])
            self._derived['train'] = DeviceMesh(
                self.device_mesh.device_type, ranks,
                mesh_dim_names=('tensor', 'replicate', 'shard'))
        return self._derived['train']

    def fsdp_mesh(self):
        """FSDP2's mesh (HSDP): the ('replicate', 'shard') dims of
        `train_mesh()` at this rank's tensor coordinate, a 2-D DeviceMesh
        of its own over the train mesh's process groups (no new group,
        and no slice of the train mesh: torch 2.11 refuses that slice
        when 'shard' has one rank)."""
        if 'fsdp' not in self._derived:
            from torch.distributed.device_mesh import DeviceMesh
            train = self.train_mesh()
            self._derived['fsdp'] = DeviceMesh.from_group(
                [train.get_group('replicate'), train.get_group('shard')],
                train.device_type, train.mesh[self.coordinate('tensor')],
                mesh_dim_names=('replicate', 'shard'))
        return self._derived['fsdp']


    def expert_mesh(self):
        """The DeviceMesh of a MoE model's expert weights, built once
        (every rank together): dims ('tensor', 'expert', 'replicate') over
        the same ranks, where 'replicate' flattens ('dcn', 'pipeline',
        'data', 'fsdp'), the ranks that hold the same experts."""
        if 'expert' not in self._derived:
            from torch.distributed.device_mesh import DeviceMesh
            shape = self.shape
            ranks = self.device_mesh.mesh.permute(5, 4, 0, 1, 2, 3).reshape(
                shape['tensor'], shape['expert'], -1)
            self._derived['expert'] = DeviceMesh(
                self.device_mesh.device_type, ranks,
                mesh_dim_names=('tensor', 'expert', 'replicate'))
        return self._derived['expert']


DeviceList = Sequence[Union[str, torch.device]]
# One RankMesh per (plan, devices, backend) and process group: every
# DeviceMesh makes new process groups, which every rank must create
# together and which live as long as the group.
_MESHES: Dict[tuple, RankMesh] = {}


def forget_meshes() -> None:
    """Drop the built meshes (their process group is being destroyed)."""
    _MESHES.clear()


def _cuda_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device('cuda', i) for i in range(n)]


def build_serve_mesh(tensor: int,
                     n_heads: Optional[int] = None,
                     n_kv_heads: Optional[int] = None,
                     devices: Optional[DeviceList] = None,
                     backend: Optional[str] = None) -> RankMesh:
    """This rank's view of the mesh of a tensor-parallel serve replica
    over the first `tensor` devices (default: the CUDA devices, which
    must number at least `tensor`), as the JAX `build_serve_mesh`."""
    devices = list(devices if devices is not None else _cuda_devices())
    if len(devices) < tensor:
        raise ValueError(
            f'tensor={tensor} needs {tensor} devices, have {len(devices)}')
    plan = plan_serve_mesh(tensor, tensor=tensor, n_heads=n_heads,
                           n_kv_heads=n_kv_heads)
    return build_mesh(plan, devices[:tensor], backend)


def _default_devices() -> Tuple[list, bool]:
    """(rank r's device for every rank, whether they span hosts): this
    host's cards, or, when the group is SKYTPU_NUM_NODES hosts of as many
    ranks as this host has cards, card r % cards for rank r."""
    cards = _cuda_devices()
    hosts = int(os.environ.get('SKYTPU_NUM_NODES', '1'))
    if (hosts > 1 and cards and dist.is_initialized() and
            dist.get_world_size() == hosts * len(cards)):
        return [cards[r % len(cards)]
                for r in range(dist.get_world_size())], True
    return cards, False


def build_mesh(plan: Optional[MeshPlan] = None,
               devices: Optional[DeviceList] = None,
               backend: Optional[str] = None) -> RankMesh:
    """This rank's view of the mesh `plan` over `devices` (default: every
    CUDA device, or every host's cards: `_default_devices`), rank r on
    devices[r].  Call it in every rank of a
    process group of len(devices) ranks whose backend is `backend`
    (default 'nccl' for CUDA devices, 'gloo' for the CPU)."""
    across_hosts = False
    if devices is None:
        devices, across_hosts = _default_devices()
    devices = [torch.device(d) for d in devices]
    if plan is None:
        plan = plan_mesh(len(devices))
    plan.validate(len(devices))
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {'cuda', 'cpu'}:
        raise ValueError(f'a mesh spans CUDA devices or the CPU, one of '
                         f'them: got {devices}')
    kind = kinds.pop()
    if kind == 'cuda':
        devices = [torch.device('cuda', d.index or 0) for d in devices]
    backend = backend or ('nccl' if kind == 'cuda' else 'gloo')
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f'{backend!r}')
    if backend == 'nccl':
        if kind != 'cuda':
            raise ValueError('the nccl backend needs CUDA devices')
        if len(set(devices)) < len(devices) and not across_hosts:
            raise ValueError(
                f'NCCL puts one rank on a card, and {devices} repeats a '
                f'card; two ranks share a card only over '
                f"backend='gloo'")
    if not dist.is_initialized():
        raise RuntimeError(
            'build_mesh runs in each rank of a process group '
            '(parallel/group.py joins one); torch.distributed is not '
            'initialized in this process')
    if dist.get_world_size() != len(devices):
        raise ValueError(f'the process group has {dist.get_world_size()} '
                         f'ranks, the mesh {len(devices)} devices')
    if dist.get_backend() != backend:
        raise ValueError(f'the process group runs {dist.get_backend()}, '
                         f'the mesh asks for {backend}')
    key = (plan, tuple(devices), backend, dist.group.WORLD)
    if key in _MESHES:
        return _MESHES[key]
    from torch.distributed.device_mesh import DeviceMesh
    device = devices[dist.get_rank()]
    if kind == 'cuda':
        torch.cuda.set_device(device)
    ranks = torch.arange(len(devices)).reshape(
        plan.dcn, plan.pipeline, plan.data, plan.fsdp, plan.expert,
        plan.tensor)
    device_mesh = DeviceMesh(kind, ranks, mesh_dim_names=MESH_AXES)
    control = (dist.group.WORLD if backend == 'gloo'
               else dist.new_group(backend='gloo'))
    mesh = RankMesh(device_mesh, device, backend, control)
    _MESHES[key] = mesh
    return mesh
