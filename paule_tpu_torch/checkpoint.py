"""Checkpoint and resume of a :class:`paule_tpu_torch.api.Paule`
(counterpart of ``paule_tpu/checkpoint.py:61-123``).

One file holds what ``paule_tpu.checkpoint.paule_state`` holds: the
predictive and inverse models' parameters with their Adam states, the
embedder's and both generators' parameters, the ``smiling``,
``use_speech_classifier`` and ``use_somatosensory_feedback`` flags, the
state of the instance's random generator (in place of the JAX key) and the
replay buffer.  As there, the flags are recorded, not restored: they are
the constructor's choice.

The format is the port's own: plain dicts, lists, tensors and numbers,
written with ``torch.save`` and read back with ``torch.load(...,
weights_only=True)``, which runs no code from the file.  (The JAX
package's file pickles optax state, and reading it would import jax.)
Tensors are stored on the CPU; replay rows held as numpy arrays become
tensors.
"""

import pickle

import numpy as np
import torch

FORMAT = "paule_tpu_torch.checkpoint"
FORMAT_VERSION = 1


def _plain(value):
    """A replay-buffer cell as something ``weights_only`` loading admits."""
    if torch.is_tensor(value):
        return value.detach().cpu()
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.array(value))
    if isinstance(value, np.generic):
        return value.item()
    return value


def _cpu(tree):
    """Every tensor of a nest of dicts, lists and tuples, on the CPU."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def paule_state(paule):
    """The resumable state of ``paule`` as a dict of plain values."""
    data = paule.continue_data.data
    return {
        "format": FORMAT, "version": FORMAT_VERSION,
        "pred_params": _cpu(paule.pred_model.state_dict()),
        "pred_opt_state": _cpu(paule.pred_trainer.optimizer.state_dict()),
        "inv_params": _cpu(paule.inv_model.state_dict()),
        "inv_opt_state": _cpu(paule.inv_trainer.optimizer.state_dict()),
        "embedder_params": _cpu(paule.embedder.state_dict()),
        "cp_gen_params": _cpu(paule.cp_gen_model.state_dict()),
        "mel_gen_params": _cpu(paule.mel_gen_model.state_dict()),
        "use_speech_classifier": paule.use_speech_classifier,
        "use_somatosensory_feedback": paule.use_somatosensory_feedback,
        "smiling": paule.smiling,
        "generator_state": paule.generator.get_state(),
        # as in the JAX package, an empty buffer is stored as None
        "continue_data": ({c: [_plain(v) for v in rows]
                           for c, rows in data.items()}
                          if len(paule.continue_data) > 0 else None),
    }


def save(path, state):
    torch.save(state, path)


def load(path):
    """-> the state dict in the file at ``path``; a file that is not one
    of the port's checkpoints raises ``ValueError``."""
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as exc:
        raise ValueError(
            f"{path} is not a paule_tpu_torch checkpoint ({exc})") from exc
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(f"{path} is not a paule_tpu_torch checkpoint")
    return state


def restore_paule_state(paule, state):
    """Load a :func:`paule_state` dict into ``paule``; parameters and Adam
    states are cast to its device and dtype."""
    paule.pred_model.load_state_dict(state["pred_params"])
    paule.pred_trainer.optimizer.load_state_dict(state["pred_opt_state"])
    paule.inv_model.load_state_dict(state["inv_params"])
    paule.inv_trainer.optimizer.load_state_dict(state["inv_opt_state"])
    paule.embedder.load_state_dict(state["embedder_params"])
    paule.cp_gen_model.load_state_dict(state["cp_gen_params"])
    paule.mel_gen_model.load_state_dict(state["mel_gen_params"])
    paule.generator.set_state(state["generator_state"])
    paule.continue_data.data = state["continue_data"]
    return paule
