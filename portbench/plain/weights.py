"""The release's weights, read once: flat arrays for the reference and the
same arrays as parameter trees for the program.

The release (``paule_tpu/pretrained_weights/paule_tpu_release_v1.npz``,
read in place as data) holds float16 arrays under their paths, e.g.
``predictive.lstm[0].w_ih``, and a JSON manifest that mirrors each model's
tree (the layout of ``paule_tpu_torch/release.py:85-103``, frozen here).
"""

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RELEASE = os.path.join(os.path.dirname(os.path.dirname(HERE)), "paule_tpu",
                       "pretrained_weights", "paule_tpu_release_v1.npz")


def _unflatten(node, arrays):
    if "__leaf__" in node:
        return arrays[node["__leaf__"]]
    if "__none__" in node:
        return None
    if "__list__" in node:
        return [_unflatten(v, arrays) for v in node["__list__"]]
    return {k: _unflatten(v, arrays) for k, v in node.items()}


def load(path=RELEASE):
    """-> ``(arrays, trees)``: ``{path: float16 array}`` and ``{model key:
    tree of the same arrays}``."""
    with np.load(path) as npz:
        manifest = json.loads(bytes(npz["__manifest__"].tobytes()).decode())
        arrays = {k: npz[k] for k in npz.files if k != "__manifest__"}
    trees = {k: _unflatten(node, arrays)
             for k, node in manifest["trees"].items()}
    return arrays, trees
