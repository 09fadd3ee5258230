"""Checkpoint and resume of a :class:`paule_tpu_torch.api.Paule`
(counterpart of ``paule_tpu/checkpoint.py:61-123``).

One file holds what ``paule_tpu.checkpoint.paule_state`` holds: the
predictive and inverse models' parameters with their Adam states, the
embedder's and both generators' parameters, the speech classifier's
parameters, the cp->tube and tube->mel models' parameters with their Adam
states and the tube embedder's parameters when the instance has them
(``paule_tpu/checkpoint.py:71-83``), the ``smiling``,
``use_speech_classifier`` and ``use_somatosensory_feedback`` flags, the
states of the instance's random generators (in place of the JAX key; the
tube embedder's dropout generator is restored only on a device of the kind
it was saved from) and the replay buffer.  As there, the flags are
recorded, not restored: they are the constructor's choice, and a variant's
state is restored only into an instance that has the variant.  The
physical forward model (``physical_forward=True``) has no parameters: its
entry is empty and its Adam state ``None``.

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
    """A replay-buffer cell as something ``weights_only`` loading admits;
    a tensor as a CPU copy of its own."""
    if torch.is_tensor(value):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.array(value))
    if isinstance(value, np.generic):
        return value.item()
    return value


def _cpu(tree):
    """A copy of a nest of dicts, lists and tuples, every tensor a CPU copy
    of its own: ``.cpu()`` of a CPU tensor is the tensor itself, which
    training then updates in place."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _opt_state(trainer):
    """A trainer's Adam state, ``None`` for a trainer without
    parameters."""
    if trainer.optimizer is None:
        return None
    return _cpu(trainer.optimizer.state_dict())


def _load_opt_state(trainer, state):
    if trainer.optimizer is not None and state is not None:
        trainer.optimizer.load_state_dict(_cpu(state))


def _somato_parts(paule):
    """The somatosensory variant's modules and optimizers, keyed as
    ``paule_tpu/checkpoint.py:76-81`` keys their state."""
    return {"cp_tube_params": paule.cp_tube_model,
            "cp_tube_opt_state": paule.tube_trainer.optimizer,
            "tube_mel_params": paule.tube_mel_model,
            "tube_mel_opt_state": paule.tube_mel_trainer.optimizer,
            "tube_embedder_params": paule.tube_embedder}


def paule_state(paule):
    """The resumable state of ``paule`` as a dict of plain values."""
    data = paule.continue_data.data
    state = {
        "format": FORMAT, "version": FORMAT_VERSION,
        "pred_params": _cpu(paule.pred_model.state_dict()),
        "pred_opt_state": _opt_state(paule.pred_trainer),
        "inv_params": _cpu(paule.inv_model.state_dict()),
        "inv_opt_state": _cpu(paule.inv_trainer.optimizer.state_dict()),
        "embedder_params": _cpu(paule.embedder.state_dict()),
        "cp_gen_params": _cpu(paule.cp_gen_model.state_dict()),
        "mel_gen_params": _cpu(paule.mel_gen_model.state_dict()),
        "use_speech_classifier": paule.use_speech_classifier,
        "use_somatosensory_feedback": paule.use_somatosensory_feedback,
        "smiling": paule.smiling,
        "generator_state": paule.generator.get_state(),
        # a card's generator state does not fit the CPU's, and back
        "tube_generator_device": paule.tube_generator.device.type,
        "tube_generator_state": paule.tube_generator.get_state().cpu(),
        # as in the JAX package, an empty buffer is stored as None
        "continue_data": ({c: [_plain(v) for v in rows]
                           for c, rows in data.items()}
                          if len(paule.continue_data) > 0 else None),
    }
    if paule.use_speech_classifier:
        state["speech_classifier_params"] = _cpu(
            paule.speech_classifier.state_dict())
    if paule.use_somatosensory_feedback:
        state.update({k: _cpu(v.state_dict())
                      for k, v in _somato_parts(paule).items()})
    return state


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
    states are cast to its device and dtype.  ``state`` is left as it was:
    the optimizers and the replay buffer get copies of its tensors and
    lists (``Optimizer.load_state_dict`` keeps a CPU tensor of the right
    dtype as it is, and Adam updates its moments in place)."""
    paule.pred_model.load_state_dict(state["pred_params"])
    _load_opt_state(paule.pred_trainer, state["pred_opt_state"])
    paule.inv_model.load_state_dict(state["inv_params"])
    paule.inv_trainer.optimizer.load_state_dict(_cpu(state["inv_opt_state"]))
    paule.embedder.load_state_dict(state["embedder_params"])
    paule.cp_gen_model.load_state_dict(state["cp_gen_params"])
    paule.mel_gen_model.load_state_dict(state["mel_gen_params"])
    paule.generator.set_state(state["generator_state"])
    if state.get("tube_generator_device") == paule.tube_generator.device.type:
        paule.tube_generator.set_state(state["tube_generator_state"])
    if paule.use_speech_classifier and "speech_classifier_params" in state:
        paule.speech_classifier.load_state_dict(
            state["speech_classifier_params"])
    if paule.use_somatosensory_feedback and "cp_tube_params" in state:
        for k, v in _somato_parts(paule).items():
            v.load_state_dict(_cpu(state[k]))
    paule.continue_data.data = _cpu(state["continue_data"])
    return paule
