"""Corpus planning (counterpart of ``paule_tpu/experiments.py``).

* :func:`discover_targets` lists the audio files of a corpus (one
  subdirectory per label), leaving out those that already have results, so
  an interrupted run resumes;
* :func:`plan_corpus` plans them one at a time through
  ``Paule.plan_resynth``, saving each result, its audio and a checkpoint as
  it goes;
* :func:`plan_corpus_batched` plans them in batches of utterances of one
  length through :func:`paule_tpu_torch.parallel.batched.plan_batch_resynth`;
* :func:`collect_results` gathers each utterance's final losses into a
  table, and :func:`load_continue_data` samples a replay-buffer seed from a
  validation table.  These two need pandas, which the port imports nowhere
  else.
"""

import os
import pickle
import random

import numpy as np

from .dsp import audio as audio_io
from .dsp.targets import audio_target_to_mel
from .parallel import batched

AUDIO_EXTS = (".flac", ".wav")


def discover_targets(data_dir, *, save_dir=None, shuffle=True, seed=23082022):
    """The audio files under ``data_dir``, shuffled from ``seed``, without
    those whose results (``<stem>_results.pkl`` or ``<stem>_batched.pkl``)
    are under ``save_dir``."""
    files = []
    for root, _dirs, names in os.walk(data_dir):
        for name in sorted(names):
            if name.endswith(AUDIO_EXTS) and not name.startswith("._"):
                files.append(os.path.join(root, name))
    if shuffle:
        random.Random(seed).shuffle(files)
    if save_dir and os.path.isdir(save_dir):
        done = set()
        for _root, _dirs, names in os.walk(save_dir):
            for name in names:
                if (name.endswith("_results.pkl")
                        and name != "final_results.pkl"):
                    done.add(name[:-len("_results.pkl")])
                elif name.endswith("_batched.pkl"):
                    done.add(name[:-len("_batched.pkl")])
        files = [f for f in files
                 if os.path.splitext(os.path.basename(f))[0] not in done]
    return files


def load_continue_data(valid_pickle, *, n_samples=12, seed=23082022):
    """``n_samples`` rows of a validation DataFrame pickle as a replay
    buffer seed, flagged ``segment_data=True`` (needs pandas)."""
    import pandas as pd

    valid = pd.read_pickle(valid_pickle)
    rng = random.Random(seed)
    idx = rng.sample(range(len(valid)), min(n_samples, len(valid)))
    cols = [c for c in ("vector", "cp_norm", "melspec_norm_synthesized",
                        "tube_norm") if c in valid.columns]
    data = valid.iloc[idx][cols].copy().reset_index(drop=True)
    data["segment_data"] = True
    return data


def label_of(path):
    """The label of ``<name>_<label>.<ext>``."""
    stem = os.path.splitext(os.path.basename(path))[0]
    return stem.split("_")[-1]


def plan_corpus(paule_model, files, save_dir, *, semvec_lookup=None,
                checkpoint_every=10, write_audio=True, plan_kwargs=None,
                verbose=True):
    """Plan every file of ``files`` with ``paule_model.plan_resynth(
    **plan_kwargs)`` (default ``objective="acoustic_semvec"``), writing
    ``<save_dir>/<label>/<stem>_results.pkl`` and, with ``write_audio``, its
    planned and best audio, and a checkpoint every ``checkpoint_every``
    utterances and at the end.  ``semvec_lookup``: a mapping or callable
    ``label -> (300,)`` target semvec; without one the embedder's of the
    target is used.  -> the result files' paths."""
    plan_kwargs = dict(plan_kwargs or {})
    plan_kwargs.setdefault("objective", "acoustic_semvec")
    plan_kwargs.setdefault("initialize_from", "acoustic")
    plan_kwargs.setdefault("verbose", False)
    os.makedirs(save_dir, exist_ok=True)
    if not files and verbose:
        print("plan_corpus: no target files to plan (corpus empty or "
              "everything already planned)")
    result_files = []
    for i, path in enumerate(files):
        label = label_of(path)
        out_dir = os.path.join(save_dir, label)
        os.makedirs(out_dir, exist_ok=True)
        prefix = os.path.join(out_dir,
                              os.path.splitext(os.path.basename(path))[0])
        kwargs = dict(plan_kwargs)
        if semvec_lookup is not None:
            vec = (semvec_lookup(label) if callable(semvec_lookup)
                   else semvec_lookup.get(label))
            if vec is not None:
                kwargs["target_semvec"] = np.asarray(vec)
        if verbose:
            print(f"[{i + 1}/{len(files)}] planning {path}")
        results = paule_model.plan_resynth(target_acoustic=path, **kwargs)
        with open(prefix + "_results.pkl", "wb") as fh:
            pickle.dump(results, fh, protocol=4)
        result_files.append(prefix + "_results.pkl")
        if write_audio:
            audio_io.write(prefix + "_planned.flac", results.prod_sig,
                           results.prod_sr)
            best = paule_model.best_synthesis_acoustic
            if best is not None and best.prod_sig is not None:
                audio_io.write(prefix + "_best_planned.flac", best.prod_sig,
                               results.prod_sr)
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            paule_model.save_state(os.path.join(save_dir, "checkpoint.pkl"))
    if checkpoint_every:
        paule_model.save_state(os.path.join(save_dir, "checkpoint.pkl"))
    return result_files


def plan_corpus_batched(paule_model, targets, *, mesh=None, max_batch=8,
                        semvecs=None, plan_kwargs=None, verbose=True,
                        on_result=None, pad_to_multiple=None):
    """Plan ``targets`` (audio paths, ``(sig, sr)`` pairs or normalised
    ``(F, 60)`` mels) in batches: the utterances are bucketed by their
    exact mel length, each bucket cut into batches of at most
    ``max_batch``, and each batch planned by one
    ``batched.plan_batch_resynth(**plan_kwargs)`` call (default
    ``objective="acoustic_semvec"``).  ``semvecs``: optional ``(300,)``
    target semvecs aligned with ``targets``.  ``mesh``: a
    :class:`~paule_tpu_torch.parallel.mesh.Mesh` over which each batch
    that its ``dp`` divides is sharded; other batches run unsharded.

    ``pad_to_multiple=k`` appends silence frames (0 in normalised units)
    to each target mel up to a multiple of ``k`` frames, so that near
    lengths share a bucket; each utterance's plan, audio and mel are
    trimmed back to its own length (its loss curves are of the padded
    target).

    -> per utterance, in input order, a dict of ``planned_cp``,
    ``prod_sig``, ``prod_mel``, ``prod_loss_curve`` (one value per outer
    iteration) and the variant's other ``*_curve`` series;
    ``on_result(index, result)`` is called as each batch completes."""
    plan_kwargs = dict(plan_kwargs or {})
    plan_kwargs.setdefault("objective", "acoustic_semvec")

    def to_mel(target):
        if isinstance(target, str) or (isinstance(target, tuple)
                                       and len(target) == 2):
            return audio_target_to_mel(target, device=paule_model.device,
                                       dtype=paule_model.dtype)[2]
        return np.asarray(target)

    mels = [to_mel(t) for t in targets]
    true_frames = [m.shape[0] for m in mels]
    if pad_to_multiple:
        k = int(pad_to_multiple)
        mels = [np.pad(m, ((0, -m.shape[0] % k), (0, 0))) for m in mels]
    buckets = {}
    for i, m in enumerate(mels):
        buckets.setdefault(m.shape[0], []).append(i)

    results = [None] * len(targets)
    for length in sorted(buckets):
        idxs = buckets[length]
        for start in range(0, len(idxs), max_batch):
            batch_idx = idxs[start:start + max_batch]
            tsem = (np.stack([np.asarray(semvecs[i]) for i in batch_idx])
                    if semvecs is not None else None)
            if verbose:
                print(f"planning bucket len={length}: "
                      f"{len(batch_idx)} utterances")
            # a leftover batch that dp does not divide runs unsharded
            # (paule_tpu/experiments.py:205-207)
            batch_mesh = (mesh if mesh is None
                          or len(batch_idx) % mesh.shape["dp"] == 0
                          else None)
            out = batched.plan_batch_resynth(
                paule_model, np.stack([mels[i] for i in batch_idx]), tsem,
                mesh=batch_mesh, **plan_kwargs)
            for j, i in enumerate(batch_idx):
                n_true = true_frames[i]
                per = {"planned_cp": out["planned_cp"][j][:2 * n_true],
                       "prod_sig": out["prod_sigs"][j][
                           :(2 * n_true - 1) * 110],
                       "prod_mel": out["prod_mels"][j][:n_true]}
                per.update({key: val[:, j] for key, val in out.items()
                            if key.endswith("_curve")})
                results[i] = per
                if on_result is not None:
                    on_result(i, per)
    return results


def collect_results(save_dir, *, out_txt="results_loss.txt",
                    out_pickle="final_results.pkl"):
    """One row per utterance planned under ``save_dir`` (``*_results.pkl``
    of :func:`plan_corpus`, ``*_batched.pkl`` of the batched CLI) with its
    last produced, planned and semvec losses; written as a tab-separated
    ``out_txt`` and a DataFrame pickle ``out_pickle`` (needs pandas).
    -> the DataFrame."""
    import pandas as pd

    rows = []
    for root, _dirs, names in os.walk(save_dir):
        for name in sorted(names):
            if name.endswith("_batched.pkl"):
                with open(os.path.join(root, name), "rb") as fh:
                    res = pickle.load(fh)
                rows.append({
                    "file": name[:-len("_batched.pkl")],
                    "label": os.path.basename(root),
                    "prod_loss": float(res["prod_loss_curve"][-1]),
                    "planned_loss": np.nan, "planned_mel_loss": np.nan,
                    "vel_loss": np.nan, "jerk_loss": np.nan,
                    "prod_semvec_loss": (
                        float(res["prod_semvec_loss_curve"][-1])
                        if "prod_semvec_loss_curve" in res else np.nan),
                    "planned_cp": res["planned_cp"],
                    "prod_mel": res["prod_mel"], "prod_semvec": None})
                continue
            if (not name.endswith("_results.pkl")
                    or name == "final_results.pkl"):
                continue
            with open(os.path.join(root, name), "rb") as fh:
                res = pickle.load(fh)

            def last(series):
                return series[-1] if series else np.nan

            rows.append({
                "file": name[:-len("_results.pkl")],
                "label": os.path.basename(root),
                "prod_loss": last(res.prod_loss_steps),
                "planned_loss": last(res.planned_loss_steps),
                "planned_mel_loss": last(res.planned_mel_loss_steps),
                "vel_loss": last(res.vel_loss_steps),
                "jerk_loss": last(res.jerk_loss_steps),
                "prod_semvec_loss": last(res.prod_semvec_loss_steps),
                "planned_cp": res.planned_cp, "prod_mel": res.prod_mel,
                "prod_semvec": res.prod_semvec})
    all_cols = ["file", "label", "prod_loss", "planned_loss",
                "planned_mel_loss", "vel_loss", "jerk_loss",
                "prod_semvec_loss", "planned_cp", "prod_mel", "prod_semvec"]
    final = pd.DataFrame(rows, columns=all_cols)
    if out_txt:
        final[all_cols[:8]].to_csv(os.path.join(save_dir, out_txt), sep="\t",
                                   index=False)
    if out_pickle:
        final.to_pickle(os.path.join(save_dir, out_pickle), protocol=4)
    return final
