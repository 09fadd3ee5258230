"""Reader and writer of pretrained-weight releases, and the bridge between
the JAX package's parameter trees and the port's modules.

The release ``paule_tpu/pretrained_weights/paule_tpu_release_v1.npz`` is
data only: float16 arrays plus a JSON manifest (``__manifest__``) that
mirrors each model's parameter tree with leaf ids at the leaves.  This is
the port's own copy of ``paule_tpu/release.py:38-161``; the in-repo file is
read in place and never written.  A release the port writes
(:func:`save_release`) has the same layout, so both packages load it.

``Paule(pretrained_dir=None)`` loads the release when
:func:`release_available`; otherwise, and under ``PAULE_TPU_NO_RELEASE=1``,
its models start from the seeded random initialisation and
:func:`print_fallback_hint_once` says so once per process.
"""

import hashlib
import json
import os

import numpy as np
import torch

RELEASE_VERSION = "v1"
RELEASE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "paule_tpu", "pretrained_weights")
RELEASE_BASENAME = "paule_tpu_release_{version}.npz"
#: model keys a release may carry (``paule_tpu/release.py`` ``MODEL_KEYS``)
MODEL_KEYS = ("predictive", "inverse", "embedder", "cp_gan", "mel_gan",
              "speech_classifier", "cp_tube", "tube_mel", "tube_embedder")

_PRINTED_FALLBACK_HINT = False


def release_path(version=RELEASE_VERSION):
    """The in-repo release file of ``version``."""
    return os.path.join(RELEASE_DIR,
                        RELEASE_BASENAME.format(version=version))


RELEASE_PATH = release_path()


def release_available(version=RELEASE_VERSION):
    """Whether the release file of ``version`` exists; ``False`` under
    ``PAULE_TPU_NO_RELEASE=1``."""
    if os.environ.get("PAULE_TPU_NO_RELEASE", "0") == "1":
        return False
    return os.path.exists(release_path(version))


def print_fallback_hint_once():
    """Say, once per process, that the models start from the seeded random
    initialisation (``paule_tpu/release.py:156-161``)."""
    global _PRINTED_FALLBACK_HINT
    if not _PRINTED_FALLBACK_HINT:
        _PRINTED_FALLBACK_HINT = True
        print("paule_tpu_torch: no pretrained weight release found — models "
              "start from seeded random init (train your own with "
              "paule_tpu_torch/tools/train_release_weights.py, or pass "
              "pretrained_dir=)")


def _flatten(tree, prefix, arrays):
    """A tree of dicts, lists and array leaves -> its manifest node; each
    leaf goes into ``arrays`` under its path, floats as float16."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}.{k}", arrays)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__list__": [_flatten(v, f"{prefix}[{i}]", arrays)
                             for i, v in enumerate(tree)]}
    if tree is None:
        return {"__none__": True}
    leaf = tree.detach().cpu().numpy() if torch.is_tensor(tree) else (
        np.asarray(tree))
    if np.issubdtype(leaf.dtype, np.floating):
        leaf = leaf.astype(np.float16)
    arrays[prefix] = leaf
    return {"__leaf__": prefix}


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


def load_release(path=None):
    """-> ``({model key: parameter tree of numpy arrays}, metadata)`` of the
    release at ``path`` (default :func:`release_path`); the arrays keep
    their stored dtype (float16)."""
    with np.load(path or release_path()) as npz:
        payload = json.loads(bytes(npz["__manifest__"].tobytes()).decode())
        arrays = {k: npz[k] for k in npz.files if k != "__manifest__"}
    return ({key: _unflatten(node, arrays)
             for key, node in payload["trees"].items()}, payload["meta"])


def load_release_metadata(path=None, version=RELEASE_VERSION):
    """The metadata of the release at ``path`` (default the in-repo release
    of ``version``)."""
    with np.load(path or release_path(version)) as npz:
        return json.loads(
            bytes(npz["__manifest__"].tobytes()).decode())["meta"]


def check_release_path(path):
    """-> ``path`` made absolute; raises ``ValueError`` if it lies in the
    JAX package's release directory, which the port never writes."""
    path = os.path.abspath(path)
    if os.path.dirname(path) == os.path.abspath(RELEASE_DIR):
        raise ValueError(f"{path} is in the JAX package's release "
                         f"directory {RELEASE_DIR}; write elsewhere")
    return path


def save_release(weights, *, path, version=RELEASE_VERSION, metadata=None):
    """Write a release in the JAX package's layout: ``weights`` maps model
    keys (of :data:`MODEL_KEYS`) to parameter trees in the JAX layout
    (:func:`params_to_jax`).  ``path`` is required, and the in-repo
    release's directory is refused.  -> ``path``."""
    unknown = set(weights) - set(MODEL_KEYS)
    if unknown:
        raise ValueError(f"unknown model keys: {sorted(unknown)}")
    path = check_release_path(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays, manifest = {}, {}
    for key, tree in weights.items():
        manifest[key] = _flatten(tree, key, arrays)
    meta = {"version": version, "models": sorted(weights), "format": 1,
            **(metadata or {})}
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"meta": meta, "trees": manifest}).encode(),
        dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def sha256(path):
    """The SHA-256 hex digest of the file at ``path``."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def params_to_jax(module):
    """The inverse of :func:`params_from_jax`: ``module``'s state dict
    (parameters and persistent buffers) -> the JAX parameter tree, nested
    dicts with lists where the names have list indices, of numpy
    arrays."""
    root = {}
    for name, value in module.state_dict().items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy().copy()
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[k]) for k in sorted(node, key=int)]
    return {k: _lists(v) for k, v in node.items()}


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
