"""Process groups and mesh construction.

Counterpart of ``stheno_tpu/parallel/hosts.py``. Each process calls
:func:`initialize_hosts` once, which wraps
``torch.distributed.init_process_group``; the distributed paths then run
over a ``DeviceMesh`` of its ranks (:func:`make_hybrid_mesh`, or
``cholesky.make_data_mesh``). The backend is NCCL when the default device
(``config.default_device``) is CUDA and gloo on the CPU. NCCL takes one
rank per GPU; several ranks on one GPU need a gloo group (gloo takes CUDA
tensors and stages them through the host), which a caller creates itself
with ``backend="gloo"``.

Typical multi-process driver::

    from stheno_torch.parallel import initialize_hosts, make_hybrid_mesh

    initialize_hosts("tcp://10.0.0.1:29500", num_processes=8, process_id=rank)
    mesh = make_hybrid_mesh(chains=2)  # ("chain", "data")
    # dist_nlml / dist_elbo over mesh, axis="data", as usual.

Every collective of a group made here times out after ``timeout``
(default ten minutes), so a rank that never arrives fails the others
instead of hanging them.
"""

import datetime
import logging
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import config

__all__ = ["initialize_hosts", "make_hybrid_mesh"]

_log = logging.getLogger(__name__)

#: Collective timeout of the groups made here.
TIMEOUT = datetime.timedelta(minutes=10)


def device_type():
    """``"cuda"`` or ``"cpu"``: the type of the default device, which the
    meshes are made on."""
    return config.resolve_device().type


def _backend():
    return "nccl" if device_type() == "cuda" else "gloo"


def _init(backend, **kwargs):
    dev = config.resolve_device()
    if backend == "nccl" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=kwargs.pop("timeout", None) or TIMEOUT, **kwargs)


def init_single_rank():
    """A process group of this process alone, over a ``FileStore`` in a
    temporary directory (no port): NCCL for a CUDA default device, gloo on
    the CPU."""
    path = os.path.join(tempfile.mkdtemp(prefix="stheno_torch_"), "store")
    _init(_backend(), store=dist.FileStore(path, 1), rank=0, world_size=1)


def initialize_hosts(coordinator_address=None, num_processes=None, process_id=None, *,
                     backend=None, timeout=None):
    """Join this process to the process group (idempotent).

    ``coordinator_address`` is an init URL (``"tcp://host:port"``,
    ``"file:///path"``) or ``"host:port"``; with none, the group reads
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``num_processes`` and ``process_id`` are the world size and this
    process's rank. A second call on a joined process does nothing. A
    caller that names a cluster of more than one process asked for one:
    a failure raises. A single process with no cluster (no address, no
    ``MASTER_ADDR``, or a failed ``env://`` init) logs it and returns, so
    single-process scripts can share the driver's code."""
    if dist.is_initialized():
        return
    explicit = num_processes is not None and num_processes > 1
    if coordinator_address is None and "MASTER_ADDR" not in os.environ and not explicit:
        _log.info("single-process run; distributed init skipped (no cluster address)")
        return
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    kwargs = {"init_method": url, "timeout": timeout}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    try:
        _init(backend or _backend(), **kwargs)
    except (RuntimeError, ValueError) as e:
        if explicit or int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise
        _log.info("single-process run; distributed init skipped (%s)", e)


def make_hybrid_mesh(chains=1, axis_chain="chain", axis_data="data"):
    """A 2-D ``(chains, data)`` mesh over the ranks of the process group
    (a group of one rank if there is none): the chain axis for
    embarrassingly parallel chains or restarts, the data axis for the
    sharded Gram, Cholesky and ELBO paths. ``chains`` must divide the world
    size; ``chains=1`` is a pure data mesh. Every rank must call it."""
    if not dist.is_initialized():
        init_single_rank()
    world = dist.get_world_size()
    if world % chains != 0:
        raise ValueError(f"chains={chains} does not divide device count {world}.")
    grid = torch.arange(world).reshape(chains, world // chains)
    return DeviceMesh(device_type(), grid, mesh_dim_names=(axis_chain, axis_data))
