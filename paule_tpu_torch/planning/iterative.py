"""Chunked planning of long utterances (counterpart of
``paule_tpu/planning/iterative.py:26-95``).

* An acoustic target's normalised mel is cut into chunks of ``chunk_size``
  mel frames, a tail shorter than a quarter chunk joining the last chunk.
* A semvec-only target is a sequence of words, each a ``(300,)`` vector
  with its length in mel frames; each word plans against the target mel
  the mel generator makes of it, under ``objective="acoustic_semvec"``
  unless the caller names another.
* Each chunk or word is one ``plan_resynth`` call, initialised from the
  inverse model (as in the JAX package, whatever ``initialize_from`` the
  caller passes) and conditioned on the last ``overlap`` cp frames of the
  plan before it through ``past_cp``.
* The plans are stitched, each without its conditioned prefix.
"""

import numpy as np

from ..dsp.targets import audio_target_to_mel


def _chunks(n_frames, chunk_size):
    """``[(start, end)]`` mel-frame ranges covering ``n_frames``."""
    chunks, start = [], 0
    while start < n_frames:
        end = min(start + chunk_size, n_frames)
        if n_frames - end < chunk_size // 4 and end < n_frames:
            end = n_frames
        chunks.append((start, end))
        start = end
    return chunks


def plan_iterative(paule_obj, *, target_acoustic=None, target_semvecs=None,
                   target_seq_lengths=None, overlap=8, chunk_size=64,
                   **kwargs):
    """Plan ``target_acoustic`` (a WAV path or ``(sig, sr)``), or the words
    ``target_semvecs`` of ``target_seq_lengths`` mel frames each, chunk by
    chunk through ``paule_obj.plan_resynth(**kwargs)``.  -> ``(planned_cp
    (2 x mel frames, 30), [the results of each chunk])``."""
    if overlap % 2 != 0:
        raise ValueError("overlap must be an even number of cp frames")
    if target_acoustic is None and target_semvecs is None:
        raise ValueError(
            "Either target_acoustic or target_semvecs has to be not None.")
    if target_acoustic is not None:
        _sig, _sr, mel = audio_target_to_mel(
            target_acoustic, device=paule_obj.device, dtype=paule_obj.dtype)
        targets = [{"target_acoustic": mel[a:b]}
                   for a, b in _chunks(mel.shape[0], chunk_size)]
    else:
        target_semvecs = np.asarray(target_semvecs)
        if target_semvecs.ndim == 1:
            target_semvecs = target_semvecs[None]
        if target_seq_lengths is None:
            raise ValueError(
                "semvec-only iterative planning needs target_seq_lengths "
                "(mel frames per word)")
        target_seq_lengths = np.atleast_1d(np.asarray(target_seq_lengths))
        if len(target_seq_lengths) != len(target_semvecs):
            raise ValueError(
                "target_semvecs and target_seq_lengths must have the same "
                "length")
        targets = [{"target_acoustic": None, "target_semvec": semvec,
                    "target_seq_length": int(length)}
                   for semvec, length in zip(target_semvecs,
                                             target_seq_lengths)]
        kwargs.setdefault("objective", "acoustic_semvec")
    kwargs.setdefault("verbose", False)
    kwargs.pop("initialize_from", None)

    results, parts, past_cp = [], [], None
    for target in targets:
        res = paule_obj.plan_resynth(past_cp=past_cp,
                                     initialize_from="acoustic", **target,
                                     **kwargs)
        results.append(res)
        past_len = 0 if past_cp is None else past_cp.shape[0]
        parts.append(res.planned_cp[past_len:])
        past_cp = res.planned_cp[-overlap:] if overlap > 0 else None
    return np.concatenate(parts, axis=0), results
