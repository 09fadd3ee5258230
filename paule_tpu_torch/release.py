"""Reader for the in-repo pretrained-weight release, and the bridge from the
JAX package's parameter trees to the port's modules.

The release ``paule_tpu/pretrained_weights/paule_tpu_release_v1.npz`` is
data only: float16 arrays plus a JSON manifest (``__manifest__``) that
mirrors each model's parameter tree with leaf ids at the leaves.  This is
the port's own copy of the reader of ``paule_tpu/release.py:64-135``; the
file is read in place.
"""

import json
import os

import numpy as np
import torch

RELEASE_VERSION = "v1"
RELEASE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "paule_tpu", "pretrained_weights",
    f"paule_tpu_release_{RELEASE_VERSION}.npz")


def _unflatten(node, arrays):
    if isinstance(node, dict):
        if "__leaf__" in node:
            return arrays[node["__leaf__"]]
        if "__none__" in node:
            return None
        if "__list__" in node:
            return [_unflatten(v, arrays) for v in node["__list__"]]
        return {k: _unflatten(v, arrays) for k, v in node.items()}
    raise ValueError(f"malformed release manifest node: {node!r}")


def load_release(path=RELEASE_PATH):
    """-> ``({model key: parameter tree of numpy arrays}, metadata)``; the
    arrays keep their stored dtype (float16)."""
    with np.load(path) as npz:
        payload = json.loads(bytes(npz["__manifest__"].tobytes()).decode())
        arrays = {k: npz[k] for k in npz.files if k != "__manifest__"}
    return ({key: _unflatten(node, arrays)
             for key, node in payload["trees"].items()}, payload["meta"])


def params_from_jax(tree, prefix=""):
    """A JAX parameter tree (nested dicts and lists of arrays) -> a flat
    state dict of tensors whose names join the tree's keys and list indices
    with dots, as the port's modules name their parameters."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        return {prefix: torch.from_numpy(np.array(tree))}
    out = {}
    for k, v in items:
        out.update(params_from_jax(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_into(module, tree, *, device, dtype):
    """Fill ``module`` from a JAX parameter tree (every parameter must be
    present) and move it to ``device`` and ``dtype``."""
    module.to(device=device, dtype=dtype)
    module.load_state_dict(params_from_jax(tree), strict=True)
    return module
