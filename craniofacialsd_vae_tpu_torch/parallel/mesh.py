"""Data meshes and their layouts (counterpart of ``parallel/mesh.py``,
its data half).

JAX runs one process over every local chip and names them in one
``Mesh``. PyTorch runs one process per card, so a port mesh is one of
two things:

- **ranks**: this process's place in a ``torch.distributed`` process
  group (the group, its rank, its world size and the rank's device), for
  training: every rank holds the whole model and its own batch slice,
  and the gradients meet in an all-reduce (``train_parallel.py``);
- **devices**: in one process, a list of devices, for serving and the
  fit: the model is replicated on each device and each runs its own
  slice of the batch (or of the restarts) with its own graphs.

``make_data_mesh`` gives the ranks' mesh where a process group is
initialized (``multihost.initialize_multihost`` or ``train.py
--data_parallel``), else the devices' mesh over every visible card. The
backend of a process group follows its device: NCCL for the card, Gloo
for the CPU; nothing switches to another when one fails.

The member half: ``make_member_mesh`` is a devices' mesh over which
``shard_member_axis`` places an ensemble's members (or a sweep's
variants) in contiguous blocks of K/n, moving each to its block's
device. The scanned trainers (``training/ensemble.py``,
``training/sweep.py``) then run each block's members in that device's
own graph. Members share no state, so there is no collective. A device
may be named more than once: each naming holds a block with its own
graphs, as another card would.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["DATA_AXIS", "MEMBER_AXIS", "Mesh", "make_data_mesh",
           "make_member_mesh", "shard_batch", "shard_member_axis",
           "member_on", "replicate", "replicate_model", "same_device",
           "backend_for", "MeanReducer"]

DATA_AXIS = "data"

#: the axis of an ensemble's members or a sweep's variants
MEMBER_AXIS = "member"


def backend_for(device) -> str:
    """The process group's backend for ranks on ``device``: NCCL for a
    CUDA device, Gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclass
class Mesh:
    """A data mesh: ``devices`` (in the ranks' form, this rank's device
    alone), and for ranks their ``group`` (None: the default group),
    ``rank`` and ``world``. ``ranks`` says which form it is."""
    devices: list
    ranks: bool = False
    rank: int = 0
    world: int = 1
    group: object = field(default=None, repr=False)
    axis: str = DATA_AXIS

    @property
    def size(self) -> int:
        """Replicas in the mesh: the world size, or the device count."""
        return self.world if self.ranks else len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's first (in the ranks' form, only) device."""
        return self.devices[0]


def make_data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """The data mesh. With an initialized process group: the ranks' mesh
    over its default group (``n_devices``, where given, must be its world
    size), on the rank's device (``cuda:<local rank>`` under NCCL).
    Otherwise the devices' mesh over the first ``n_devices`` of
    ``devices`` (default: every visible card; raises without one)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and int(n_devices) != world:
            raise ValueError(f"the process group has {world} ranks; a data "
                             f"mesh of {n_devices} needs as many")
        if devices is not None:
            device = torch.device(list(devices)[0])
        elif dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
        return Mesh(devices=[device], ranks=True, rank=dist.get_rank(),
                    world=world)
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:int(n_devices)]
    if not devices:
        raise ValueError("a data mesh needs at least one device")
    return Mesh(devices=devices)


def make_member_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """The member mesh: the devices' mesh over the first ``n_devices`` of
    ``devices`` (default: every visible card; raises without one), for
    ``shard_member_axis``. A device named twice holds two blocks."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:int(n_devices)]
    if not devices:
        raise ValueError("a member mesh needs at least one device")
    return Mesh(devices=devices, axis=MEMBER_AXIS)


def shard_member_axis(mesh: Mesh, state):
    """An ensemble or sweep state (``training.ensemble.EnsembleState``)
    in contiguous blocks of K/n members over the mesh's n devices: each
    member moved to its block's device (one geometry a device) and the
    state's ``blocks`` set, ``[(device, member indices)]``. K must be a
    multiple of n."""
    n = len(mesh.devices)
    if not hasattr(state, "members"):
        raise ValueError(f"{type(state).__name__} has no member axis to "
                         "shard (an ensemble or sweep state)")
    k = len(state.members)
    if k % n:
        raise ValueError(
            f"a {k}-member state cannot shard over {n} devices: the member "
            f"axis must be a multiple of the mesh size — pick K as a "
            f"multiple of {n}, or a smaller mesh "
            "(make_member_mesh(n_devices=...))")
    per = k // n
    members, geoms, blocks = list(state.members), {}, []
    for b, dev in enumerate(mesh.devices):
        ids = list(range(b * per, (b + 1) * per))
        for i in ids:
            members[i] = member_on(members[i], dev, geoms.get(str(dev)))
            geoms[str(dev)] = members[i].model.geom
        blocks.append((dev, ids))
    return dataclasses.replace(state, members=members, blocks=blocks)


def member_on(member, device, geom=None):
    """An ensemble member (``training.ensemble.MemberState``) on
    ``device``: itself where it lies there, else a copy of its model (on
    ``geom``, where given, else its geometry moved), its head and its
    optimizers' states, each optimizer made anew over the copy (on the
    card ``capturable``)."""
    if same_device(member.model.geom.device, device):
        return member
    model = replicate_model(member.model, device)
    if geom is not None:
        model.geom = geom
    head = None if member.head is None \
        else replicate_model(member.head, device)
    return dataclasses.replace(
        member, model=model, head=head,
        optimizer=_optimizer_on(member.optimizer, model),
        head_optimizer=None if member.head_optimizer is None
        else _optimizer_on(member.head_optimizer, head))


def _optimizer_on(optimizer, module):
    """``coupled_adam`` over ``module``'s parameters with ``optimizer``'s
    hyperparameters and state."""
    from ..training.trainer import coupled_adam

    group = optimizer.param_groups[0]
    new = coupled_adam(module.parameters(), group["lr"],
                       group["weight_decay"])
    state = optimizer.state_dict()
    for g in state["param_groups"]:
        g["capturable"] = new.param_groups[0]["capturable"]
    new.load_state_dict(state)
    return new


def shard_batch(mesh: Mesh, batch):
    """A global batch ``[G, ...]`` (a tensor, an array, or a dict of them)
    along its leading axis: in the ranks' form this rank's slice on its
    device, in the devices' form one slice per device."""
    def one(x):
        x = torch.as_tensor(x)
        n = mesh.size
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{n} replicas")
        b = x.shape[0] // n
        if mesh.ranks:
            return x[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device)
        return [x[i * b:(i + 1) * b].to(d)
                for i, d in enumerate(mesh.devices)]

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


def same_device(a, b) -> bool:
    """Whether two devices are one: ``cuda`` names the current card."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type or a.type != "cuda":
        return a == b

    def index(d):
        return torch.cuda.current_device() if d.index is None else d.index
    return index(a) == index(b)


def replicate_model(model: torch.nn.Module, device) -> torch.nn.Module:
    """A copy of an ``SDVAE`` (or an MLP head) on ``device``: its
    parameters and, for the model, its geometry."""
    rep = copy.deepcopy(model)
    geom = getattr(model, "geom", None)
    rep = rep.to(device)
    if geom is not None:
        rep.geom = geom.to(device)
    return rep


def replicate(mesh: Mesh, tree):
    """Replicate ``tree`` (a module, a tensor, or a dict or list of them)
    over the mesh. Ranks: tensors moved to the rank's device (a module
    stays where it lies, on the rank's device) and, with more than one
    rank, every tensor (a module's parameters and buffers) broadcast from
    rank 0 in place, so that the replicas start equal. Devices: one copy
    per device, a list."""
    if mesh.ranks:
        out = tree if isinstance(tree, torch.nn.Module) \
            else _to(tree, mesh.device)
        if mesh.world > 1:
            for t in _tensors(out):
                dist.broadcast(t.data, src=0, group=mesh.group)
        return out
    return [_to(tree, d) for d in mesh.devices]


def _to(tree, device):
    if isinstance(tree, torch.nn.Module):
        return replicate_model(tree, device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class MeanReducer:
    """``reduce(tensors)``: each tensor replaced in place by its sum over
    the ranks of a process group divided by ``divisor``: one all-reduce
    ``SUM`` of their concatenation in fp32, then the division (none by
    1). Given a mesh, its ranks and its world size: the mean over them
    (JAX ``pmean``), and at world size 1 the values come back unchanged,
    bit for bit. On the card the collective is NCCL's and runs inside a
    captured graph as well; the communicator is set up by the eager
    warm-up steps before a capture."""

    def __init__(self, mesh: Mesh | None = None, group=None,
                 divisor: int = 1):
        if mesh is not None:
            if not mesh.ranks:
                raise ValueError("a reducer needs the ranks' mesh")
            group, divisor = mesh.group, mesh.world
        self.group, self.divisor = group, int(divisor)

    def __call__(self, tensors: list) -> None:
        tensors = [t for t in tensors if t is not None]
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        if self.divisor != 1:
            flat /= self.divisor
        at = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[at:at + n].view(t.shape))
            at += n
