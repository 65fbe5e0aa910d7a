"""Process groups and meshes over every rank (counterpart of
``proxtpu/parallel/distributed.py``).

JAX runs one controller over many devices; PyTorch runs one process per
device, as ``torchrun`` starts them.  :func:`initialize_distributed` brings
up the default process group, and :func:`global_mesh` builds a
``DeviceMesh`` over all of its ranks.  The backend is named by the caller
or follows the device type (``nccl`` for ``cuda``, ``gloo`` for ``cpu``);
nothing switches backend or device by itself, and a ``cuda`` request
without a card raises.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _require_device(device_type):
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's meshes and process groups run on "
            "the card unless the caller asks for the CPU "
            "(device_type='cpu')")


def _init_method(address):
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, auto=False, backend=None,
                           device_type="cuda"):
    """Bring up the default process group; returns the world size.

    With all-default arguments, or ``num_processes=1`` and no address, this
    is a no-op that returns 1 (the world size if a group already exists).
    ``auto=True`` initializes from the environment (``env://``: the
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` that
    ``torchrun`` sets).  An explicit ``coordinator_address``
    (``"host:port"`` or ``"tcp://host:port"``) takes precedence, with the
    given world size and rank.  ``backend`` defaults to ``nccl`` for
    ``device_type="cuda"`` and ``gloo`` for ``"cpu"``."""
    if dist.is_initialized():
        return dist.get_world_size()
    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1)
    if not explicit and not auto:
        return 1
    _require_device(device_type)
    backend = backend or _BACKENDS[device_type]
    if explicit:
        if coordinator_address is None or process_id is None:
            raise ValueError(
                "initialize_distributed needs coordinator_address, "
                "num_processes and process_id together")
        dist.init_process_group(
            backend, init_method=_init_method(coordinator_address),
            world_size=1 if num_processes is None else int(num_processes),
            rank=int(process_id))
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()


def world_mesh(axis_shape, axis_names, device_type):
    """A ``DeviceMesh`` of ``axis_shape`` named ``axis_names`` over every
    rank of the default group, in rank order.  The port's meshes span the
    whole world: a smaller mesh would need every rank to agree on which
    ranks it leaves out, so that raises a ``ValueError``."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_device(device_type)
    axis_shape, axis_names = tuple(int(n) for n in axis_shape), \
        tuple(axis_names)
    if len(axis_shape) != len(axis_names):
        raise ValueError(f"mesh shape {axis_shape} and names {axis_names} "
                         "differ in length")
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed(...) (or "
            "torch.distributed.init_process_group) before building a mesh")
    world = dist.get_world_size()
    if math.prod(axis_shape) != world:
        raise ValueError(
            f"a mesh of shape {axis_shape} holds {math.prod(axis_shape)} "
            f"ranks, the world has {world}: the port's meshes span every "
            "rank")
    return init_device_mesh(device_type, axis_shape,
                            mesh_dim_names=axis_names)


def global_mesh(axis_shape, axis_names, devices=None, device_type="cuda"):
    """A mesh over all ranks (all hosts' cards), e.g. ``(num_hosts, 8)``
    named ``("dp", "tp")``: lay the fast-changing axis innermost so that
    its collectives stay on one host's links.  ``devices``, where given,
    must list every rank in order (the JAX package's argument takes a
    subset of devices; the port's meshes span the world)."""
    if devices is not None and [int(d) for d in devices] != list(
            range(dist.get_world_size() if dist.is_initialized() else 1)):
        raise ValueError("global_mesh: devices must list every rank in "
                         "order; the port's meshes span the world")
    return world_mesh(axis_shape, axis_names, device_type)
