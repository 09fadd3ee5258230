"""Data and tensor parallelism over devices (counterpart of
``paule_tpu/parallel/mesh.py``), for one process that drives every device
itself, as JAX's single controller does.

A :class:`Mesh` lays its devices out as a ``dp x tp`` grid, row-major as
JAX's ``np.asarray(devices).reshape(dp, tp)``.  The batched planners take
it as ``mesh=`` (:mod:`paule_tpu_torch.parallel.batched`): the batch axis
is split into ``dp`` shards, shard ``d`` planning on row ``d``'s lead
device (``mesh.row(d)[0]``) against that row's replica of the models, and
continue-learning reduces the replicas' gradients to the primary copy.
With ``tp > 1`` each replica's LSTM layers have their 4H gate axis split
in contiguous column blocks over the row's ``tp`` devices
(:func:`shard_lstm_params`, :class:`~paule_tpu_torch.models.blocks.
TPLSTMLayer`): what is split is the input projection ``x @ w_ih + b`` and
the ``w_hh`` gradient, each block on its device; the recurrence is not,
since splitting it would put an exchange of ``h`` and a barrier across
the devices inside every time step.  It runs whole on the lead device
(one B1 forward and one B2 backward per layer and call, B3/B4 for a fused
pair, :mod:`paule_tpu_torch.ops.lstm`), as the JAX package's Pallas
kernels take ``W_hh`` whole.  A device may be listed more than once
(``["cpu", "cpu"]``, ``["cuda:0"] * 4``): the sharded code then runs,
shard after shard, on one device.
"""

import copy

import torch

from .. import tracing
from ..models.blocks import LSTMLayer, TPLSTMLayer


def _indexed(dev):
    """``cuda`` as ``cuda:<current device>``, so that it equals a tensor's
    device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices along the axes ``("dp", "tp")``; :attr:`shape` is ``{"dp":
    dp, "tp": tp}`` as JAX's ``Mesh.shape``, and :attr:`devices` the flat
    list, row after row."""

    def __init__(self, devices, dp, tp=1):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if dp * tp != len(self.devices):
            raise ValueError(f"dp*tp={dp * tp} != n_devices="
                             f"{len(self.devices)}")
        self.shape = {"dp": dp, "tp": tp}

    def row(self, d):
        """Row ``d``'s ``tp`` devices; the first is the row's lead."""
        tp = self.shape["tp"]
        return self.devices[d * tp:(d + 1) * tp]

    @property
    def leads(self):
        """Each row's lead device, in order."""
        return [self.row(d)[0] for d in range(self.shape["dp"])]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, shape={self.shape})"


def make_mesh(n_devices=None, *, dp=None, tp=None, devices=None):
    """A :class:`Mesh` over ``devices`` (default: every CUDA device), the
    first ``n_devices`` of them if given; with neither ``dp`` nor ``tp``,
    ``dp`` is the number of devices and ``tp`` 1 (``paule_tpu/parallel/
    mesh.py:19-38``).  ``dp * tp`` other than the number of devices raises
    ``ValueError``."""
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


def lstm_param_spec():
    """How one LSTM layer's weights lie on the mesh, as JAX's
    ``PartitionSpec``s (``paule_tpu/parallel/mesh.py:41-43``): per weight,
    the mesh axis each tensor axis is split over, ``None`` for whole; the
    4H gate axis goes over ``tp``."""
    return {"w_ih": (None, "tp"), "w_hh": (None, "tp"), "b": ("tp",)}


def _split_layer(layer, devices):
    """The weights ``layer`` (a ``{"w_ih", "w_hh", "b"}`` dict) split by
    :func:`lstm_param_spec` into ``len(devices)`` contiguous blocks, each a
    copy on its device: -> one dict per device.  A gate axis that the
    number of devices does not divide raises ``ValueError``, as JAX's
    ``device_put`` does."""
    spec = lstm_param_spec()
    tp = len(devices)
    blocks = [{} for _ in devices]
    with torch.no_grad():
        for key, w in layer.items():
            axis = spec[key].index("tp")
            if w.shape[axis] % tp:
                raise ValueError(f"{key} {tuple(w.shape)}: its axis {axis} "
                                 f"does not split into tp={tp} blocks")
            for block, part, dev in zip(blocks, w.chunk(tp, dim=axis),
                                        devices):
                block[key] = part.clone(
                    memory_format=torch.contiguous_format).to(dev)
    return blocks


def shard_lstm_params(mesh, layers):
    """The LSTM layers ``layers`` (``{"w_ih", "w_hh", "b"}`` dicts of
    tensors) laid out on ``mesh`` as ``paule_tpu/parallel/mesh.py:46-53``
    places them: ``out[d][l][t]`` is layer ``l``'s column block ``t`` on
    ``mesh.row(d)[t]``, the same blocks in every row."""
    return [[_split_layer(layer, mesh.row(d)) for layer in layers]
            for d in range(mesh.shape["dp"])]


def shard_batch(mesh, x):
    """The leading (batch) axis of the tensor ``x`` split into ``dp``
    contiguous shards, shard ``d`` on row ``d``'s lead device; a batch
    that ``dp`` does not divide raises ``ValueError``."""
    dp = mesh.shape["dp"]
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"dp={dp} shards")
    return [part.to(dev) for part, dev in zip(x.chunk(dp), mesh.leads)]


def _device_of(module):
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    return None


def _tp_replica(module, devices):
    """A deep copy of ``module`` on ``devices[0]`` whose
    :class:`LSTMLayer`s are :class:`TPLSTMLayer`s over ``devices``."""
    rep = copy.deepcopy(module).to(devices[0])
    for parent in list(rep.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, LSTMLayer):
                setattr(parent, name, TPLSTMLayer(
                    _split_layer(child.params(), devices),
                    requires_grad=child.w_hh.requires_grad))
    return rep


def replicate(mesh, module):
    """One replica of ``module`` per row of the mesh.  With ``tp = 1``:
    ``module`` itself on its own device (and where it holds no tensors),
    a deep copy elsewhere.  With ``tp > 1``: a deep copy on the row's lead
    device with every LSTM layer split over the row's devices
    (:class:`TPLSTMLayer`), row 0 included, so ``module`` itself is never
    split; a module without tensors is its own replica.  ``None`` gives
    ``None`` per row."""
    if module is None:
        return [None] * mesh.shape["dp"]
    home = _device_of(module)
    if mesh.shape["tp"] == 1:
        return [module if home is None or dev == home
                else copy.deepcopy(module).to(dev) for dev in mesh.devices]
    return [module if home is None else _tp_replica(module, mesh.row(d))
            for d in range(mesh.shape["dp"])]


def param_pairs(module, replica):
    """Each parameter ``p`` of ``module`` with its counterparts in
    ``replica``, a copy of it from :func:`replicate`: ``(p, q, cols)``,
    ``q`` holding ``p[..., cols]`` (a block of a :class:`TPLSTMLayer`) or,
    with ``cols`` ``None``, all of ``p``."""
    for name, sub in module.named_modules():
        rsub = replica.get_submodule(name)
        if isinstance(rsub, TPLSTMLayer):
            for key, p in sub.params().items():
                for q, cols in zip(getattr(rsub, key), rsub.columns()):
                    yield p, q, cols
        else:
            for pname, p in sub.named_parameters(recurse=False):
                yield p, getattr(rsub, pname), None


def reduce_grads(module, replicas):
    """Sum the parameter gradients of each replica that is not ``module``
    itself into ``module``'s, each block of a split layer into its
    columns (a block's gradient copied to ``module``'s device)."""
    for rep in replicas:
        if rep is module:
            continue
        for p, q, cols in param_pairs(module, rep):
            grad = q.grad.to(p.device)
            if cols is None:
                p.grad = grad if p.grad is None else p.grad + grad
            else:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad[..., cols] += grad


def sync_replicas(module, replicas):
    """Copy ``module``'s parameters and buffers into each replica that is
    not ``module`` itself, each block of a split layer its columns; with
    no such replica, nothing happens.  A traced call that copies counts
    the call and the bytes copied, and times the copies as the device span
    ``sync_replicas`` on the current stream of ``module``'s device, where
    a copy to another card runs."""
    copies = [rep for rep in replicas if rep is not module]
    if not copies:
        return
    if tracing.ON:
        device = _device_of(module)
        start = tracing.device_span_start(device)
    with torch.no_grad():
        for rep in copies:
            for p, q, cols in param_pairs(module, rep):
                q.copy_(p if cols is None else p[..., cols])
            for name, buf in module.named_buffers():
                rep.get_buffer(name).copy_(buf)
    if tracing.ON:
        tracing.device_span_end("sync_replicas", start, device)
        tracing.count("sync_replicas")
        tracing.count("sync_replicas_bytes", sum(
            q.numel() * q.element_size() for rep in copies
            for _p, q, _cols in param_pairs(module, rep)) + len(copies) * sum(
                b.numel() * b.element_size() for b in module.buffers()))
