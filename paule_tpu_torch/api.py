"""The :class:`Paule` facade of the port (counterpart of
``paule_tpu/api.py``), for the main path: ``plan_resynth(target_acoustic=
<wav path or (sig, sr)>, initialize_from="acoustic", objective="acoustic" |
"acoustic_semvec", continue_learning=True)``, with ``past_cp`` and the
inverse model's continue-learning.

Options outside that path raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.  Synthesis, the produced-audio metrics and
continue-learning run synchronously after each outer iteration's planning
segment; the JAX package's overlap and deferred-fetch machinery is
numerically exact there (``paule_tpu/api.py:122-146``, ``:935-955``), so the
results are the same.
"""

import contextlib
import os
import random
import time

import numpy as np
import torch

from . import synth
from .dsp.mel import librosa_melspec, melspec_44100
from .dsp.targets import audio_target_to_mel
from .models.embedder import EmbeddingModel
from .models.forward import ForwardModel
from .models.inverse import InverseModelMelTimeSmoothResidual
from .ops.normalize import inv_normalize_cp, normalize_mel
from .planning import engine
from .planning.engine import MEL_WEIGHT, SEMANTIC_WEIGHT
from .planning.results import (BestSynthesisAcoustic, BestSynthesisSemantic,
                               PlanningResults)
from .planning.trainer import ModelTrainer, ReplayBuffer, train_epochs
from .release import load_into, load_release


@contextlib.contextmanager
def _phase(timings, name):
    """Adds the wall time of the block to ``timings[name]`` and marks it as
    ``plan_resynth.<name>`` in a ``torch.profiler`` trace."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"plan_resynth.{name}"):
        yield
    timings[name] += time.perf_counter() - t0


def _np(t):
    return t.detach().cpu().numpy().astype(np.float64)


class Paule:
    """The predictive, inverse and embedder models with the release
    weights, their continue-learning trainers and replay buffer, the
    synthesizer pool, and the best-synthesis trackers.

    ``device=None`` means ``"cuda"``, which raises when no CUDA device is
    present; pass ``device="cpu"`` to run on the CPU (the LSTM kernels'
    plain versions).

    ``continue_data`` seeds the replay buffer: a mapping from the columns
    of :data:`~paule_tpu_torch.planning.trainer.COLUMNS` to equal-length
    sequences (a pandas DataFrame is one), capped at 1000 rows.  As in the
    reference, with ``continue_data=None`` the buffer stays empty for good:
    produced snapshots train the models within each ``plan_resynth`` call
    but are not kept across calls."""

    def __init__(self, *, device=None, dtype=torch.float32, seed=20200905,
                 speaker="default", smiling=False, continue_data=None,
                 use_somatosensory_feedback=False,
                 use_speech_classifier=False):
        if use_somatosensory_feedback or use_speech_classifier:
            raise NotImplementedError(
                "the somatosensory and speech-classifier variants are not "
                "ported yet (ROADMAP.md, 'Modules to port', item 10)")
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Paule: no CUDA device; pass device='cpu' to run on the "
                    "CPU")
            # Full-f32 math on the card, as the JAX reference computes
            # (paule_tpu/config.py:56-70): matmuls and cuDNN convolutions
            # would otherwise be allowed TF32.  This is the one place the
            # port sets it.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        self.smiling = smiling
        #: explicit generator for the port's tensor randomness
        self.generator = torch.Generator().manual_seed(seed)
        #: batching and replay sampling draw from this, call for call as
        #: the JAX package draws (``paule_tpu/api.py:150``)
        self._py_rng = random.Random(seed)

        weights, _meta = load_release()
        kw = {"device": self.device, "dtype": dtype}
        self.pred_model = load_into(
            ForwardModel(num_lstm_layers=1, hidden_size=720),
            weights["predictive"], **kw).eval()
        self.inv_model = load_into(
            InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                              hidden_size=720),
            weights["inverse"], **kw).eval()
        self.embedder = load_into(
            EmbeddingModel(num_lstm_layers=2, hidden_size=720),
            weights["embedder"], **kw).eval()
        # frozen: planning takes no weight gradients; the trainers unfreeze
        # their model only inside a training step
        self.embedder.requires_grad_(False)
        self.pred_trainer = ModelTrainer(self.pred_model, loss="rmse")
        self.inv_trainer = ModelTrainer(self.inv_model, loss="cp_trajectory")
        self.continue_data = ReplayBuffer(continue_data, rng=self._py_rng)

        self.synth_pool = synth.SynthPool(size=min(8, os.cpu_count() or 2),
                                          speaker_path=speaker)
        self.best_synthesis_acoustic = None
        self.best_synthesis_semantic = None
        #: per-phase wall-clock split of the most recent plan_resynth
        self.last_planning_timings = None

    def close(self):
        self.synth_pool.close()

    def _tensor(self, x):
        """A copy of ``x`` on the device (never a view of a numpy array
        that the caller keeps)."""
        return torch.tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)

    def _embed(self, mel):
        with torch.no_grad():
            return self.embedder(mel)

    def _synthesize(self, cps_norm):
        """Normalised cp ``(L, T, 30)`` -> audio ``(L, n)``, sr."""
        cps = inv_normalize_cp(np.asarray(cps_norm, dtype=np.float64))
        if not np.isfinite(cps).all():
            raise ValueError("non-finite cp trajectory (planning diverged?)")
        audio, sr, errors = self.synth_pool.speak_batch(cps)
        if errors.any() or not np.isfinite(audio).all():
            raise ValueError(f"synthesis failed (error codes {errors})")
        return audio, sr

    def _prod_metrics(self, sigs, target_mel, target_semvec, want_semvec):
        """Produced-audio metrics of all logged snapshots in one batch:
        mels, mel losses and, with ``want_semvec``, semvecs and their
        losses.  -> (those as float64 numpy, the produced mels on the
        device, which continue-learning trains on)."""
        with torch.no_grad():
            prod_mel = normalize_mel(melspec_44100(self._tensor(sigs)))
            out = {"prod_mel": prod_mel,
                   "prod_loss": MEL_WEIGHT * torch.sqrt(
                       ((prod_mel - target_mel) ** 2).mean(dim=(1, 2)))}
            if want_semvec:
                prod_semvec = self.embedder(prod_mel)
                out["prod_semvec"] = prod_semvec
                out["prod_semvec_loss"] = SEMANTIC_WEIGHT * torch.sqrt(
                    ((prod_semvec - target_semvec) ** 2).mean(dim=1))
        return {k: _np(v) for k, v in out.items()}, prod_mel

    def plan_resynth(self, *, learning_rate_planning=0.01,
                     learning_rate_learning=0.001,
                     learning_rate_learning_inv=None,
                     target_acoustic=None, target_semvec=None,
                     initial_cp=None, past_cp=None,
                     initialize_from="acoustic", objective="acoustic",
                     n_outer=5, n_inner=24, continue_learning=True,
                     continue_learning_inv=False,
                     continue_learning_tube=False,
                     add_training_data_pred=False,
                     add_training_data_inv=False,
                     n_batches=3, batch_size=8, n_epochs=10,
                     log_ii=1, log_semantics=True, log_gradients=False,
                     log_signals=False, log_cps=False, seed=None,
                     verbose=True):
        """Plan a cp trajectory that resynthesises ``target_acoustic`` (a
        WAV path, ``(sig, sr)`` or a normalised target mel ``(T, 60)``);
        argument surface and results of
        ``paule_tpu.api.Paule.plan_resynth``.

        With ``continue_learning``, each outer iteration then trains the
        predictive model (and, with ``continue_learning_inv``, the inverse
        model) for ``n_epochs`` on ``n_batches`` batches of ``batch_size``
        drawn from its logged snapshots and their produced mels, mixed
        half and half with replay rows when ``add_training_data_pred``
        (``add_training_data_inv``) is set and the replay buffer holds
        any."""
        if seed:
            self.generator.manual_seed(seed)
            self._py_rng.seed(seed)
        if objective not in engine.OBJECTIVES:
            raise ValueError("objective has to be one of 'acoustic_semvec', "
                             "'acoustic' or 'semvec'")
        if objective == "semvec" or initialize_from == "semvec" or (
                target_acoustic is None):
            raise NotImplementedError(
                "semvec objectives, semvec initialisation and semvec-only "
                "targets are not ported yet (ROADMAP.md, 'Modules to port', "
                "item 9)")
        if continue_learning_tube:
            raise NotImplementedError(
                "continue_learning_tube (the somatosensory models) is not "
                "ported yet (ROADMAP.md, 'Modules to port', item 10)")
        if learning_rate_learning:
            self.pred_trainer.set_learning_rate(learning_rate_learning)
        if learning_rate_learning_inv:
            self.inv_trainer.set_learning_rate(learning_rate_learning_inv)
        if log_ii is None:
            log_ii = n_inner
        if log_ii > n_inner:
            raise ValueError("results can only be logged between first and "
                             "last planning step")
        if past_cp is not None and past_cp.shape[0] % 2 != 0:
            raise ValueError("past_cp have to be None or the sequence length "
                             "has to be an even number")
        want_semvec = objective == "acoustic_semvec" or log_semantics

        # ---------------- target ----------------
        target_sig = target_sr = None
        if isinstance(target_acoustic, str) or (
                isinstance(target_acoustic, (tuple, list))
                and len(target_acoustic) == 2):
            target_sig, target_sr, mel = audio_target_to_mel(
                target_acoustic, device=self.device, dtype=self.dtype)
            target_mel = mel[None]
        else:
            target_mel = np.asarray(target_acoustic, dtype=np.float64)
            if target_mel.ndim == 2:
                target_mel = target_mel[None]
        target_mel_dev = self._tensor(target_mel)
        if target_semvec is None:
            target_semvec_dev = self._embed(target_mel_dev)
        else:
            target_semvec_dev = self._tensor(
                np.asarray(target_semvec).reshape(1, 300))

        # ---------------- cp initialisation ----------------
        if initial_cp is None:
            if initialize_from != "acoustic":
                raise ValueError(
                    "initialize_from has to be either 'acoustic' or 'semvec'")
            with torch.no_grad():
                cp = self.inv_model(target_mel_dev)
            initial_cp = np.clip(_np(cp)[0], -1.0, 1.0)
        else:
            if initialize_from is not None:
                raise ValueError(
                    "one of initial_cp and initialize_from has to be None")
            initial_cp = np.asarray(initial_cp, dtype=np.float64)
            if initial_cp.shape[0] != target_mel.shape[1] * 2:
                raise ValueError(f"initial_cp {initial_cp.shape[0]}, "
                                 f"target_mel {target_mel.shape[1] * 2}")
        past_len = 0
        if past_cp is not None:
            # the produced prefix joins the trajectory, pinned by the
            # constraints (paule_tpu/api.py:807-816)
            past_len = past_cp.shape[0]
            initial_cp = np.concatenate(
                (np.asarray(past_cp, dtype=np.float64), initial_cp), axis=0)
        xx = self._tensor(initial_cp[None]).requires_grad_(True)
        models = engine.Models(self.pred_model, self.embedder)
        constraints = engine.Constraints(clamp=1.05, smiling=self.smiling,
                                         past_len=past_len)

        # ---------------- initial baseline ----------------
        with torch.no_grad():
            initial_pred_mel_dev = self.pred_model(xx)
            initial_pred_semvec = _np(self._embed(initial_pred_mel_dev))[0]
        initial_pred_mel = _np(initial_pred_mel_dev)[0]
        audio, initial_sr = self._synthesize(initial_cp[None])
        initial_sig = audio[0]
        initial_prod_mel = normalize_mel(librosa_melspec(
            initial_sig, initial_sr, device=self.device, dtype=self.dtype))
        if past_len:
            # the target mel gains the produced prefix's mel
            # (paule_tpu/api.py:870-875); the target semvec stays
            target_mel = np.concatenate(
                (initial_prod_mel[None, :past_len // 2], target_mel), axis=1)
            target_mel_dev = self._tensor(target_mel)
        initial_prod_semvec = _np(self._embed(
            self._tensor(initial_prod_mel[None])))[0]
        self.best_synthesis_acoustic = BestSynthesisAcoustic(
            np.inf, initial_cp, initial_sig, initial_prod_mel,
            initial_pred_mel)
        self.best_synthesis_semantic = BestSynthesisSemantic(
            np.inf, initial_cp, initial_sig, initial_prod_semvec,
            initial_pred_semvec)

        logs = {k: [] for k in (
            "prod_loss_steps", "planned_loss_steps", "planned_mel_loss_steps",
            "vel_loss_steps", "jerk_loss_steps", "pred_semvec_loss_steps",
            "prod_semvec_loss_steps", "cp_steps", "pred_semvec_steps",
            "prod_semvec_steps", "grad_steps", "sig_steps", "prod_mel_steps",
            "pred_mel_steps", "pred_model_loss", "inv_model_loss")}
        optimizer = engine.make_optimizer(xx, learning_rate_planning)
        n_segments = n_inner // log_ii
        sig, sr, prod_mel = initial_sig, initial_sr, initial_prod_mel
        timings = {"planning": 0.0, "synthesis": 0.0, "metrics": 0.0,
                   "continue_learning": 0.0}
        start = time.perf_counter()

        for _ii_outer in range(n_outer):
            with _phase(timings, "planning"):
                seg = engine.plan_segment(
                    models, xx, optimizer, target_mel_dev, target_semvec_dev,
                    n_steps=n_inner, objective=objective,
                    log_semantics=log_semantics, constraints=constraints,
                    log_every=log_ii)
                subs = engine.SubLosses(*(_np(s) for s in seg["sub_losses"]))
                snapshots = _np(seg["xx_pre"][:, 0])
                pred_mels = _np(seg["pred_mel"][:, 0])
                pred_semvecs = (_np(seg["pred_semvec"][:, 0]) if want_semvec
                                else None)
                grads = _np(seg["grads"]) if log_gradients else None
                grad_ext = (_np(seg["grad_max"]), _np(seg["grad_min"]))
                for s in range(n_segments):
                    logs["planned_loss_steps"].append(float(subs.total[s]))
                    logs["planned_mel_loss_steps"].append(
                        float(subs.mel_loss[s]))
                    logs["vel_loss_steps"].append(float(subs.velocity_loss[s]))
                    logs["jerk_loss_steps"].append(float(subs.jerk_loss[s]))
                    if want_semvec:
                        logs["pred_semvec_loss_steps"].append(
                            float(subs.semvec_loss[s]))
                    if log_gradients:
                        logs["grad_steps"].append(grads[s])
                    if verbose:
                        if grad_ext[0][s] > 10:
                            print("WARNING: gradient is larger than 10")
                        if grad_ext[1][s] < -10:
                            print("WARNING: gradient is smaller than -10")
                        print(f"Iteration {s * log_ii + log_ii - 1}")
                        print("Planned Loss: ", float(subs.total[s]))
                        print("Mel Loss: ", float(subs.mel_loss[s]))
                        print("Vel Loss: ", float(subs.velocity_loss[s]))
                        print("Jerk Loss: ", float(subs.jerk_loss[s]))
                        print("Local Linear Loss: ",
                              float(subs.local_linear_loss[s]))

            with _phase(timings, "synthesis"):
                sigs, sr = self._synthesize(snapshots)
                sig = sigs[-1]
                if log_signals:
                    logs["sig_steps"].extend(list(sigs))

            with _phase(timings, "metrics"):
                pm, prod_mels_dev = self._prod_metrics(
                    sigs, target_mel_dev, target_semvec_dev, want_semvec)
                prod_mel = pm["prod_mel"][-1]
                prod_semvecs = []
                for s in range(n_segments):
                    prod_loss = float(pm["prod_loss"][s])
                    logs["prod_loss_steps"].append(prod_loss)
                    if verbose:
                        print("Produced Mel Loss: ", prod_loss)
                    new_ac = BestSynthesisAcoustic(
                        prod_loss, snapshots[s], sigs[s], pm["prod_mel"][s],
                        pred_mels[s])
                    if self.best_synthesis_acoustic.mel_loss > new_ac.mel_loss:
                        self.best_synthesis_acoustic = new_ac
                    if want_semvec:
                        prod_semvec_loss = float(pm["prod_semvec_loss"][s])
                        logs["prod_semvec_loss_steps"].append(prod_semvec_loss)
                        prod_semvecs.append(pm["prod_semvec"][s])
                        if verbose:
                            print("Produced Semvec Loss: ", prod_semvec_loss)
                        new_sem = BestSynthesisSemantic(
                            prod_semvec_loss, snapshots[s], sigs[s],
                            pm["prod_semvec"][s], pred_semvecs[s])
                        if (self.best_synthesis_semantic.semvec_loss
                                > new_sem.semvec_loss):
                            self.best_synthesis_semantic = new_sem
                logs["prod_mel_steps"].append(list(pm["prod_mel"]))
                logs["pred_mel_steps"].append(list(pred_mels))
                logs["pred_semvec_steps"].append(
                    list(pred_semvecs) if want_semvec else [])
                logs["prod_semvec_steps"].append(prod_semvecs)
                if log_cps:
                    logs["cp_steps"].append(list(snapshots))

            if continue_learning and n_segments:
                with _phase(timings, "continue_learning"):
                    self._continue_learning(
                        seg["xx_pre"][:, 0], prod_mels_dev,
                        target_semvec_dev[0], logs,
                        continue_learning_inv=continue_learning_inv,
                        add_training_data_pred=add_training_data_pred,
                        add_training_data_inv=add_training_data_inv,
                        n_batches=n_batches, batch_size=batch_size,
                        n_epochs=n_epochs, verbose=verbose)

        # ---------------- final results ----------------
        with torch.no_grad():
            pred_mel_dev = self.pred_model(xx)
            pred_semvec = _np(self._embed(pred_mel_dev))[0]
            prod_semvec = _np(self._embed(self._tensor(prod_mel[None])))[0]
        timings["total"] = time.perf_counter() - start
        self.last_planning_timings = timings
        if verbose:
            print("phase timings (s):",
                  {k: round(v, 3) for k, v in timings.items()})
        return PlanningResults(
            _np(xx)[0], initial_cp, initial_sig, initial_sr,
            initial_prod_mel, initial_pred_mel, target_sig, target_sr,
            target_mel[0], sig, sr, prod_mel, _np(pred_mel_dev)[0],
            initial_prod_semvec, initial_pred_semvec, prod_semvec,
            pred_semvec, logs["prod_loss_steps"], logs["planned_loss_steps"],
            logs["planned_mel_loss_steps"], logs["vel_loss_steps"],
            logs["jerk_loss_steps"], logs["pred_semvec_loss_steps"],
            logs["prod_semvec_loss_steps"], logs["cp_steps"],
            logs["pred_semvec_steps"], logs["prod_semvec_steps"],
            logs["grad_steps"], logs["sig_steps"], logs["prod_mel_steps"],
            logs["pred_mel_steps"], logs["pred_model_loss"],
            logs["inv_model_loss"])

    # ------------------------------------------------------------------
    # continue-learning
    # ------------------------------------------------------------------

    def _rows_on_device(self, rows):
        return [r.to(self.device, self.dtype) if torch.is_tensor(r)
                else self._tensor(r) for r in rows]

    def _continue_learning(self, snapshots, prod_mels, target_semvec, logs,
                           *, continue_learning_inv, add_training_data_pred,
                           add_training_data_inv, n_batches, batch_size,
                           n_epochs, verbose):
        """Train on this outer iteration's pre-update snapshots
        ``(L, T, 30)`` and the mels of the audio produced from them, both on
        the device, then offer them to the replay buffer (counterpart of
        ``paule_tpu/api.py:1523-1693``, drawing from ``self._py_rng`` in
        the same order)."""
        n_prod = snapshots.shape[0]

        def scarce(header, k_total):
            if verbose:
                print(header)
                if int(np.ceil(k_total / batch_size)) < n_batches:
                    print(f"Training on {int(np.ceil(k_total / batch_size))}"
                          " batches instead...")
                if k_total % batch_size:
                    print(f"Last batch reduced to {k_total % batch_size} "
                          f"samples instead of {batch_size}...")
                print(" ")

        def sample_training(add_training_data):
            """-> (cp rows, mel rows): this iteration's rows, or half replay
            rows followed by half of them."""
            if add_training_data and len(self.continue_data) > 0:
                want = int(0.5 * batch_size) * n_batches
                if n_prod < want:
                    # all produced rows plus as many replay rows
                    k = min(n_prod, len(self.continue_data))
                    scarce("Enhanced training data\nNot enough data produced "
                           f"to fill 50% of {n_batches} batches...", 2 * k)
                else:
                    k = min(want, len(self.continue_data))
                prod_idx = self._py_rng.sample(range(n_prod), k)
                old = self.continue_data.sample(k)
                return (self._rows_on_device(old["cp_norm"])
                        + [snapshots[i] for i in prod_idx],
                        self._rows_on_device(old["melspec_norm_synthesized"])
                        + [prod_mels[i] for i in prod_idx])
            want = batch_size * n_batches
            k = min(want, n_prod)
            if k < want:
                scarce("Produced training data\nNot enough data produced to "
                       f"fill {n_batches} batches...", k)
            idx = torch.as_tensor(self._py_rng.sample(range(n_prod), k),
                                  device=snapshots.device)
            return snapshots[idx], prod_mels[idx]

        train = dict(batch_size=batch_size, n_epochs=n_epochs,
                     rng=self._py_rng)
        cps, mels = sample_training(add_training_data_pred)
        logs["pred_model_loss"].extend(
            train_epochs(self.pred_trainer, cps, mels, **train))
        if continue_learning_inv:
            cps, mels = sample_training(add_training_data_inv)
            logs["inv_model_loss"].extend(
                train_epochs(self.inv_trainer, mels, cps, **train))
        self.continue_data.append({
            "vector": [target_semvec] * n_prod, "cp_norm": list(snapshots),
            "melspec_norm_synthesized": list(prod_mels),
            "tube_norm": [None] * n_prod, "segment_data": [False] * n_prod})
