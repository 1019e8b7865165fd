"""Device meshes and placement for multi-device inference.

Counterpart of ``d3fields_tpu/parallel/mesh.py``. JAX lays a (dp, tp)
``Mesh`` over its chips and places arrays with ``NamedSharding``s; eager
PyTorch has no sharded tensor, so here a mesh is a row of
``torch.device``s, the JAX mesh's data-parallel axis (every caller of the
JAX package sets tp = 1), and placement is explicit:

- :func:`shard_leading` cuts an array's leading axis into one chunk per
  device, each chunk on its device;
- :func:`replicate` puts one copy of a module, a tensor or a dataclass of
  tensors on each distinct device of the mesh;
- :func:`gather_leading` concatenates per-device results, in order, on the
  mesh's first device;
- :class:`ViewShards` is what every multi-view model (DINOv2, SAM,
  GroundingDINO, XMem) holds: its replicas, and a map of a call over the
  view axis. A model holds one over its own device until ``shard_views``
  gives it the mesh's.

The devices default to every visible CUDA device, and :func:`make_mesh`
raises when fewer are visible than asked for: the JAX package's
``available_devices`` falls back to virtual CPU devices, and the port does
not. A device may repeat: ``make_mesh(2, devices=["cuda:0", "cuda:0"])``
splits the work in two on one card (both halves share one replica), and
``devices=["cpu"] * 4`` is the tests' mesh. The chunks run one after the
other from the calling thread. CUDA launches are asynchronous, so the
devices of a mesh can overlap wherever a model does not wait for the host;
no run on several cards has measured it yet.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from d3fields_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A row of devices: chunk i of a split goes to ``devices[i]``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where gathered results land."""
        return self.devices[0]

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"make_mesh: cuda:{index} asked for, "
                               f"{torch.cuda.device_count()} CUDA device(s) visible")
        dev = torch.device("cuda", index)
    return dev


def make_mesh(dp: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``dp`` devices, the first ``dp`` of ``devices`` (default:
    every visible CUDA device; ``dp`` defaults to all of them). Raises when
    CUDA devices are asked for and too few are visible."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < (dp or 1):
            raise RuntimeError(
                f"make_mesh: {dp or 1} CUDA device(s) asked for, {n} visible; pass "
                "devices= to lay the mesh over others (devices=['cpu'] * n on the CPU)")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [_device(d) for d in devices]
    if dp is None:
        dp = len(devs)
    if dp < 1 or dp > len(devs):
        raise ValueError(f"a mesh of {dp} needs {dp} devices, {len(devs)} given")
    return Mesh(tuple(devs[:dp]))


def _as_tensor(x) -> Tensor:
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x)


def shard_leading(mesh: Mesh, x) -> List[Tensor]:
    """``x`` (a tensor or an array) cut along its leading axis into
    ``mesh.size`` chunks, chunk i on ``mesh.devices[i]``. Where the axis
    does not divide, the first chunks are one longer
    (``torch.tensor_split``)."""
    return [c.to(d) for c, d in zip(torch.tensor_split(_as_tensor(x), mesh.size),
                                    mesh.devices)]


def shard_leading_checked(mesh: Mesh, x) -> List[Tensor]:
    """:func:`shard_leading` with the check every ``shard_views`` needs: the
    view axis splits evenly over the mesh, and the error says so (the JAX
    function's text, its axis 'dp')."""
    x = _as_tensor(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"views count {n} not divisible by mesh axis 'dp' of "
                         f"size {mesh.size}")
    return shard_leading(mesh, x)


def _place(obj, dev: torch.device):
    if isinstance(obj, torch.nn.Module):
        if all(t.device == dev for t in itertools.chain(obj.parameters(), obj.buffers())):
            return obj
        return copy.deepcopy(obj).to(dev)
    if isinstance(obj, Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _place(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def replicate(mesh: Mesh, obj) -> Dict[torch.device, Any]:
    """One copy of ``obj`` (a module, a tensor, or a dataclass of tensors
    such as a ``FieldState``) per distinct device of ``mesh``, keyed by
    device. A device that repeats shares its copy; where ``obj`` already
    lies on a device, that device's copy is ``obj`` itself. Other values
    are shared as they are."""
    return {d: _place(obj, d) for d in mesh.distinct_devices()}


def gather_leading(mesh: Mesh, parts: Sequence):
    """Per-device results (tensors, or tuples, lists or dicts of them)
    concatenated along axis 0, in order, on the mesh's first device."""
    p0 = parts[0]
    if isinstance(p0, Tensor):
        if len(parts) == 1:
            return p0.to(mesh.first)
        return torch.cat([p.to(mesh.first) for p in parts])
    if isinstance(p0, dict):
        return {k: gather_leading(mesh, [p[k] for p in parts]) for k in p0}
    if isinstance(p0, (tuple, list)):
        return type(p0)(gather_leading(mesh, list(c)) for c in zip(*parts))
    raise TypeError(f"cannot gather {type(p0).__name__}")


class ViewShards:
    """A model replicated over the devices of a mesh, for the multi-view
    models (DINOv2, SAM, GroundingDINO, XMem): :meth:`map` splits each
    call's view axis over the mesh, runs each chunk on its device's replica
    and brings the results back in view order on the mesh's first device.
    Per-view work is independent, so no collective is needed. Over a mesh
    of one device nothing is split or copied."""

    def __init__(self, mesh: Mesh, model):
        self.mesh = mesh
        self.devices = list(mesh.devices)
        self.replicas = replicate(mesh, model)

    @classmethod
    def on(cls, device, model) -> "ViewShards":
        """The one-device shards a model holds until ``shard_views``."""
        return cls(make_mesh(1, devices=[device]), model)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.mesh.first

    def split(self, x) -> List[Tensor]:
        return shard_leading_checked(self.mesh, x)

    def gather(self, parts: Sequence):
        return gather_leading(self.mesh, parts)

    def map(self, fn: Callable, *arrays):
        """``fn(replica, device, *chunks)`` on each device, with its chunk of
        each of ``arrays``; the results gathered."""
        chunks = [self.split(a) for a in arrays]
        return self.gather([fn(self.replicas[d], d, *cs)
                            for d, *cs in zip(self.devices, *chunks)])


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device="cuda") -> bool:
    """Start ``torch.distributed`` where there is more than one process.

    The counterpart of the JAX package's ``initialize_distributed``
    (``jax.distributed.initialize``). An explicit ``coordinator_address``
    ('host:port' or a URL such as 'tcp://host:port') with
    ``num_processes`` and ``process_id`` wins. Otherwise a launcher's
    environment: ``WORLD_SIZE`` > 1 (torchrun; ``env://``), or an srun step
    with more than one task (``SLURM_STEP_NODELIST`` and ``SLURM_NTASKS`` >
    1; its rank is ``SLURM_PROCID`` and it needs ``MASTER_ADDR`` and
    ``MASTER_PORT``). A bare ``SLURM_JOB_ID`` is one process. Returns True
    when a process group was started, False in one process (callers need no
    branch). The backend is NCCL, or gloo where ``device`` is the CPU."""
    import torch.distributed as dist

    slurm = (bool(os.environ.get("SLURM_STEP_NODELIST"))
             and int(os.environ.get("SLURM_NTASKS", "1")) > 1)
    launcher = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if coordinator_address is None and not launcher and not slurm:
        return False
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and process_id")
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    elif launcher:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
            raise RuntimeError("an srun step of several tasks needs MASTER_ADDR and MASTER_PORT")
        init, world, rank = "env://", int(os.environ["SLURM_NTASKS"]), \
            int(os.environ["SLURM_PROCID"])
    if backend == "nccl":
        resolve_device(device)  # raises where no GPU is visible
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", rank)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    # torch.distributed.nn's functions take group=group.WORLD as a default
    # argument, bound at its first import. A process that first imports it
    # while a group runs (its first torch.optim optimizer does, through
    # torch._dynamo) holds that group past destroy_process_group until the
    # interpreter exits, where gloo's threads can abort the process
    # ("terminate called without an active exception"). So import it first.
    import torch.distributed.nn as _  # noqa: F401
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return True
