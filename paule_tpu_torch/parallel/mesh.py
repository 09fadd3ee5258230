"""Data parallelism over devices (counterpart of
``paule_tpu/parallel/mesh.py``), for one process that drives every device
itself, as JAX's single controller does.

A :class:`Mesh` is a list of devices with the JAX mesh's axes ``dp`` (data
parallel: the batch axis is split into ``dp`` shards, one per device) and
``tp``.  The batched planners take it as ``mesh=``
(:mod:`paule_tpu_torch.parallel.batched`): each shard plans on its own
device against a replica of the models, and continue-learning reduces the
replicas' gradients to the primary copy.  A device may be listed more than
once (``["cpu", "cpu"]``, ``["cuda:0", "cuda:0"]``): the sharded code then
runs, shard after shard, on one device.

Only ``tp=1`` is ported: sharding the LSTM gate axis over ``tp``
(``paule_tpu/parallel/mesh.py:41-53``) would need a collective inside every
step of the LSTM kernels, and no path of the JAX package uses it.
"""

import copy

import torch

TP_NOT_PORTED = (
    "tp > 1 (the LSTM gate axis sharded over devices) is not ported "
    "(ROADMAP.md, 'Modules to port', item 11, its tp bullet); use tp=1")


def _indexed(dev):
    """``cuda`` as ``cuda:<current device>``, so that it equals a tensor's
    device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices along the axes ``("dp", "tp")``; :attr:`shape` is ``{"dp":
    dp, "tp": tp}`` as JAX's ``Mesh.shape``."""

    def __init__(self, devices, dp, tp=1):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if dp * tp != len(self.devices):
            raise ValueError(f"dp*tp={dp * tp} != n_devices="
                             f"{len(self.devices)}")
        if tp != 1:
            raise NotImplementedError(TP_NOT_PORTED)
        self.shape = {"dp": dp, "tp": tp}

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, shape={self.shape})"


def make_mesh(n_devices=None, *, dp=None, tp=None, devices=None):
    """A :class:`Mesh` over ``devices`` (default: every CUDA device), the
    first ``n_devices`` of them if given; with neither ``dp`` nor ``tp``,
    ``dp`` is the number of devices and ``tp`` 1 (``paule_tpu/parallel/
    mesh.py:19-38``).  ``dp * tp`` other than the number of devices raises
    ``ValueError``, ``tp > 1`` ``NotImplementedError``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if dp is None and tp is None:
        dp, tp = n, 1
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if n == 0:
        raise ValueError("no devices for the mesh")
    return Mesh(devices, dp, tp)


def check_mesh(mesh):
    """``mesh`` if it is ``None`` or a :class:`Mesh`; else ``TypeError``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a paule_tpu_torch.parallel.mesh.Mesh "
                        f"(make_mesh) or None, got {type(mesh).__name__}")
    return mesh


def shard_batch(mesh, x):
    """The leading (batch) axis of the tensor ``x`` split into ``dp``
    contiguous shards, shard ``i`` on ``mesh.devices[i]``; a batch that
    ``dp`` does not divide raises ``ValueError``."""
    dp = mesh.shape["dp"]
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"dp={dp} shards")
    return [part.to(dev) for part, dev in zip(x.chunk(dp), mesh.devices)]


def _device_of(module):
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    return None


def replicate(mesh, module):
    """One copy of ``module`` per device of the mesh: ``module`` itself on
    its own device (and where it holds no tensors), a deep copy elsewhere.
    ``None`` gives ``None`` per device."""
    if module is None:
        return [None] * len(mesh.devices)
    home = _device_of(module)
    return [module if home is None or dev == home
            else copy.deepcopy(module).to(dev) for dev in mesh.devices]


def sync_replicas(module, replicas):
    """Copy ``module``'s parameters and buffers into each replica that is
    not ``module`` itself."""
    with torch.no_grad():
        for rep in replicas:
            if rep is not module:
                for dst, src in zip(rep.state_dict().values(),
                                    module.state_dict().values()):
                    dst.copy_(src)
