"""The :class:`Paule` facade of the port (counterpart of
``paule_tpu/api.py``): ``plan_resynth`` towards an acoustic target (a WAV
path, ``(sig, sr)`` or a normalised mel), or towards a semantic vector
alone (``target_acoustic=None``, ``target_semvec`` and
``target_seq_length``: the mel generator makes the target mel, Griffin-Lim
its audio), initialised from the inverse model (``initialize_from=
"acoustic"``) or from the cp generator (``"semvec"``), under the
objectives ``"acoustic"``, ``"semvec"`` and ``"acoustic_semvec"``, with
``past_cp`` and continue-learning of the predictive and inverse models;
planning through the physical forward model in place of the learned one
(``physical_forward=True``, :mod:`paule_tpu_torch.spectral`); the
speech-classifier variant (``use_speech_classifier``) and the
somatosensory variant (``use_somatosensory_feedback``: cp->tube, tube->mel
and a tube embedder beside the acoustic models, tube extraction from the
synthesizer, ``continue_learning_tube``); weights from the in-repo release,
a reference ``pretrained_models/`` tree, a seeded random initialisation or
injected trees; ``save_state`` and ``load_state``; ``plan_iterative``, the
chunked planner of long utterances; ``plot``, the mel panels of each
outer iteration (:mod:`paule_tpu_torch.visualize`).  Several utterances
plan as one batch through :mod:`paule_tpu_torch.parallel.batched`.

Synthesis overlaps planning (``plan_overlap``, as in the JAX package,
``paule_tpu/api.py:988-1085``): each outer iteration plans in a few
chunks of whole logging segments, and a chunk's snapshots synthesise on a
host thread while the host queues the next chunk's kernels.  The
produced-audio metrics are fetched after the next iteration's planning is
queued (``defer_metrics_fetch``).  Both change only when work happens:
the results equal the single-segment path's bit for bit.
"""

import concurrent.futures
import contextlib
import os
import pickle
import random
import time

import numpy as np
import torch

from . import checkpoint as CK
from . import synth
from .dsp.griffinlim import mel_to_sig
from .dsp.mel import librosa_melspec, melspec_44100
from .dsp.targets import audio_target_to_mel
from .models import torch_convert as TC
from .models.blocks import init_random
from .models.classifier import LinearClassifier
from .models.embedder import EmbeddingModel
from .models.forward import ForwardModel
from .models.generative import Generator
from .models.inverse import InverseModelMelTimeSmoothResidual
from .ops import losses as L
from .ops.normalize import inv_normalize_cp, normalize_mel
from .planning import engine
from .planning.engine import (MEL_WEIGHT, SEMANTIC_WEIGHT,
                              SPEECH_CLASSIFIER_WEIGHT, TUBE_MEL_WEIGHT,
                              TUBE_SEMANTIC_WEIGHT, rmse_rows)
from .planning.iterative import plan_iterative
from .planning.results import (BestSynthesisAcoustic, BestSynthesisSemantic,
                               BestSynthesisSomatosensory, PlanningResults,
                               PlanningResultsWithSomatosensory,
                               PlanningResultsWithSpeechClassifier)
from .planning.trainer import (ModelTrainer, ReplayBuffer,
                               create_epoch_batches, train_epochs)
from . import release as REL
from .release import load_into
from .spectral import SpectralForwardModel

#: model key -> (converter kind, sub-directory of a reference
#: ``pretrained_models/`` tree, a substring the file's name must hold or
#: ``None``), as ``paule_tpu/api.py:362-387`` reads them: the first ``.pt``
#: file in name order that passes the filter
PRETRAINED = {
    "predictive": ("forward", "predictive", None),
    "inverse": ("inverse", "inverse", None),
    "embedder": ("embedder", "embedder", None),
    "cp_gan": ("generator", "cp_gan", None),
    "mel_gan": ("generator", "mel_gan", None),
    "speech_classifier": ("linear_classifier", "speech_classifier", None),
    "cp_tube": ("forward", "somatosensory", "cp_to_tube"),
    "tube_mel": ("forward", "somatosensory", "tube_to_mel"),
    "tube_embedder": ("embedder", "somatosensory", "tube_to_vector"),
}


@contextlib.contextmanager
def _phase(timings, name, scope="plan_resynth"):
    """Adds the wall time of the block to ``timings[name]`` and marks it as
    ``<scope>.<name>`` in a ``torch.profiler`` trace."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"{scope}.{name}"):
        yield
    timings[name] += time.perf_counter() - t0


def _np(t):
    return t.detach().cpu().numpy().astype(np.float64)


class _HostCopy:
    """Host copies of a dict of tensors (``None`` values stay ``None``).

    With ``non_blocking`` and tensors on a CUDA device, each tensor is
    copied into a pinned host buffer without blocking the host, and a CUDA
    event is recorded after the copies; :meth:`get` waits on that event
    before it reads a buffer (a pinned buffer read before its copy has
    completed holds stale data).  Otherwise the tensors are copied to the
    host at once."""

    def __init__(self, tensors, non_blocking):
        self._event = None
        if non_blocking and any(t is not None and t.is_cuda
                                for t in tensors.values()):
            self._host = {k: None if t is None else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for k, t in tensors.items()}
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = {k: None if t is None else _np(t)
                          for k, t in tensors.items()}

    def get(self, key):
        """The float64 numpy array of ``key``, or ``None``."""
        if self._event is None:
            return self._host[key]
        self._event.synchronize()
        t = self._host[key]
        return None if t is None else _np(t)

    def all(self):
        """{key: :meth:`get` of key}."""
        return {k: self.get(k) for k in self._host}


def overlap_chunks(n_inner, log_ii, n_chunks):
    """The ``[start, end)`` inner steps of each planning chunk of an outer
    iteration (``paule_tpu/api.py:1004-1020``): ``n_chunks`` chunks of
    whole ``log_ii`` segments, the unlogged remainder ``n_inner % log_ii``
    in the last; one chunk when ``n_chunks < 2`` or fewer than two steps
    are logged."""
    n_segments = n_inner // log_ii
    if n_chunks < 2 or n_segments < 2:
        return [(0, n_inner)]
    per_chunk = -(-n_segments // n_chunks) * log_ii
    chunks, c0 = [], 0
    while c0 < n_inner:
        c1 = min(c0 + per_chunk, n_inner)
        if n_inner - c1 < log_ii:
            c1 = n_inner
        chunks.append((c0, c1))
        c0 = c1
    return chunks


def _gather(fetches):
    """The chunks' host logs (:class:`_HostCopy`), joined along the logged
    steps: the first axis, and the second of ``subs`` (fields, steps)."""
    host = {}
    for fetch in fetches:
        for key, value in fetch.all().items():
            if value is not None:
                host.setdefault(key, []).append(value)
    return {k: np.concatenate(v, axis=1 if k == "subs" else 0)
            for k, v in host.items()}


class Paule:
    """The predictive, inverse and embedder models, the cp and mel
    generators, the predictive and inverse models' continue-learning
    trainers and replay buffer, the synthesizer (the "plant"), and the
    best-synthesis trackers; the keyword surface of
    ``paule_tpu.api.Paule``.

    ``use_speech_classifier`` adds a frozen :class:`LinearClassifier`
    whose BCE against the "speech" label enters the planning loss.
    ``use_somatosensory_feedback`` adds the cp->tube and tube->mel models
    (H=360, with their own continue-learning trainers) and the tube
    embedder (two layers at H=720, dropout 0.7 while planning, its masks
    drawn from :attr:`tube_generator` on the device); the synthesizer then
    also extracts the tube.  The two variants exclude each other
    (``ValueError``), as in the JAX package.

    ``physical_forward=True`` replaces the learned predictive model by the
    differentiable physical model :class:`~paule_tpu_torch.spectral.
    SpectralForwardModel`, which has no parameters: weights for
    ``predictive`` (released, read from ``pretrained_dir`` or injected as
    ``pred_model``) are ignored, and continue-learning trains the other
    models only.

    ``device=None`` means ``"cuda"``, which raises when no CUDA device is
    present; pass ``device="cpu"`` to run on the CPU (the LSTM kernels'
    plain versions).  ``dtype=None`` means float32.

    Weights (``paule_tpu/api.py:322-395``): ``pretrained_dir=None`` loads
    the in-repo release, or, when it is missing or under
    ``PAULE_TPU_NO_RELEASE=1``, falls back to the seeded random
    initialisation with a one-time hint; ``"random"`` gives a seeded
    random initialisation drawn from :attr:`generator` (the port's own
    values, not JAX's); a path reads a reference ``pretrained_models/``
    tree of ``.pt`` state dicts, a model whose file is missing or does not
    convert falling back to the seeded random initialisation, and a
    directory that does not exist raises ``FileNotFoundError``.
    ``pred_model``, ``inv_model``, ``embedder``, ``cp_gen_model`` and
    ``mel_gen_model`` inject parameter trees in the JAX package's layout
    (nested dicts and lists of arrays), which take precedence.  The
    optimizer arguments are accepted and ignored, as in the JAX package.

    ``plant`` is the synthesizer planning drives: an object with
    ``speak(cp (T, 30)) -> (audio, sr)`` and, for one call per outer
    iteration, ``speak_batch(cps (L, T, 30)) -> (audio (L, n), sr, errors
    (L,))`` (denormalised trajectories); under the somatosensory variant
    ``speak_and_extract_tube_information`` and ``speak_and_extract_batch``
    in their place, which also return the tube; the default is a
    :class:`~paule_tpu_torch.synth.SynthPool`.  With
    ``synthesis_error="skip"`` a snapshot whose synthesis fails is replaced
    by silence and planning goes on; ``"raise"`` raises.

    ``synthesis_async=False`` synthesises trajectory by trajectory through
    ``plant.speak``, as the JAX package does.  ``plan_overlap`` (default
    ``True``: two chunks; an int: that many; ``False`` or 1: one segment)
    plans each outer iteration in chunks of whole ``log_ii`` segments, the
    unlogged remainder in the last; each chunk's snapshots synthesise on
    a host thread while the next chunks plan, and
    ``last_planning_timings["synthesis"]`` keeps only the part that did
    not overlap (``paule_tpu/api.py:122-149``).  It applies with
    ``synthesis_async`` and more than one logged step.  Two attribute
    toggles, both ``True`` by default: ``async_chunk_fetch`` copies each
    chunk's logs to pinned host memory without blocking the host, and
    ``defer_metrics_fetch`` (with continue-learning and without
    ``verbose``) fetches an iteration's produced-audio metrics only after
    the next iteration's planning is queued.  None of the three changes a
    result.

    ``continue_data`` seeds the replay buffer: a mapping from the columns
    of :data:`~paule_tpu_torch.planning.trainer.COLUMNS` to equal-length
    sequences (a pandas DataFrame is one), capped at 1000 rows.  As in the
    reference, with ``continue_data=None`` the buffer stays empty for good:
    produced snapshots train the models within each ``plan_resynth`` call
    but are not kept across calls."""

    def __init__(self, *, pred_model=None, pred_optimizer=None,
                 inv_model=None, inv_optimizer=None, embedder=None,
                 cp_gen_model=None, mel_gen_model=None,
                 use_somatosensory_feedback=False, cp_tube_model=None,
                 tube_optimizer=None, tube_mel_model=None,
                 tube_mel_optimizer=None, tube_embedder=None,
                 continue_data=None, device=None, smiling=False,
                 use_speech_classifier=False, speech_classifier=None,
                 speech_classifier_optimizer=None, pretrained_dir=None,
                 seed=20200905, dtype=None, synthesis_async=True,
                 synthesis_error="raise", physical_forward=False,
                 speaker="default", plan_overlap=True, plant=None):
        # the optimizers are made here
        del pred_optimizer, inv_optimizer, tube_optimizer, tube_mel_optimizer
        del speech_classifier_optimizer
        if use_somatosensory_feedback and use_speech_classifier:
            raise ValueError(
                "at the moment you have to choose either to use "
                "`use_somatosenrosry_feedback=True` OR to use "
                "`use_speech_classifier=True` or none")
        if synthesis_error not in ("raise", "skip"):
            raise ValueError("synthesis_error must be 'raise' or 'skip'")
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
        self.dtype = dtype or torch.float32
        self.physical_forward = physical_forward
        self.smiling = smiling
        self.use_speech_classifier = use_speech_classifier
        self.use_somatosensory_feedback = use_somatosensory_feedback
        self.synthesis_async = synthesis_async
        self.synthesis_error = synthesis_error
        #: chunks of an outer iteration's planning (class docstring)
        self.plan_overlap = plan_overlap
        #: copy each chunk's logs to the host without blocking it
        self.async_chunk_fetch = True
        #: fetch the produced metrics after the next planning is queued
        self.defer_metrics_fetch = True
        #: the port's randomness: the random initialisation and the
        #: generators' noise (CPU, so that a seed draws the same values
        #: for every device)
        self.generator = torch.Generator().manual_seed(seed)
        #: batching and replay sampling draw from this, call for call as
        #: the JAX package draws (``paule_tpu/api.py:150``)
        self._py_rng = random.Random(seed)
        #: the tube embedder's dropout masks in planning are drawn from
        #: this, on the device
        self.tube_generator = torch.Generator(
            device=self.device).manual_seed(seed)

        trees = self._resolve_weights(pretrained_dir)
        if physical_forward:
            # nothing to load, and no draw from the generator
            # (paule_tpu/api.py:166-169)
            self.pred_model = SpectralForwardModel().eval()
        else:
            self.pred_model = self._model(
                ForwardModel(num_lstm_layers=1, hidden_size=720),
                pred_model, trees.get("predictive"))
        self.inv_model = self._model(
            InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                              hidden_size=720),
            inv_model, trees.get("inverse"))
        self.embedder = self._model(
            EmbeddingModel(num_lstm_layers=2, hidden_size=720), embedder,
            trees.get("embedder"))
        self.cp_gen_model = self._model(Generator(), cp_gen_model,
                                        trees.get("cp_gan"))
        self.mel_gen_model = self._model(Generator(output_size=60),
                                         mel_gen_model, trees.get("mel_gan"))
        self.speech_classifier = None
        if use_speech_classifier:
            self.speech_classifier = self._model(
                LinearClassifier(input_dim=60, output_dim=1),
                speech_classifier, trees.get("speech_classifier"))
        self.cp_tube_model = self.tube_mel_model = self.tube_embedder = None
        if use_somatosensory_feedback:
            self.cp_tube_model = self._model(
                ForwardModel(num_lstm_layers=1, hidden_size=360,
                             output_size=10, input_size=30,
                             apply_half_sequence=False),
                cp_tube_model, trees.get("cp_tube"))
            self.tube_mel_model = self._model(
                ForwardModel(num_lstm_layers=1, hidden_size=360,
                             output_size=60, input_size=10,
                             apply_half_sequence=True),
                tube_mel_model, trees.get("tube_mel"))
            self.tube_embedder = self._model(
                EmbeddingModel(input_size=10, num_lstm_layers=2,
                               hidden_size=720, dropout=0.7,
                               post_upsampling_size=0),
                tube_embedder, trees.get("tube_embedder"))
        # frozen: planning takes no weight gradients; the trainers unfreeze
        # their model only inside a training step
        for frozen in (self.embedder, self.cp_gen_model, self.mel_gen_model,
                       self.speech_classifier, self.tube_embedder):
            if frozen is not None:
                frozen.requires_grad_(False)
        self.pred_trainer = ModelTrainer(self.pred_model, loss="rmse")
        self.inv_trainer = ModelTrainer(self.inv_model, loss="cp_trajectory")
        if use_somatosensory_feedback:
            self.tube_trainer = ModelTrainer(self.cp_tube_model, loss="rmse")
            self.tube_mel_trainer = ModelTrainer(self.tube_mel_model,
                                                 loss="rmse")
        self.continue_data = ReplayBuffer(continue_data, rng=self._py_rng)

        self.synth_pool = synth.SynthPool(size=min(8, os.cpu_count() or 2),
                                          speaker_path=speaker)
        self.plant = plant if plant is not None else self.synth_pool
        # the chunks' synthesis; one worker, since a plant's synthesizer
        # instances serve one batch at a time
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="paule-synthesis")
        self.best_synthesis_acoustic = None
        self.best_synthesis_semantic = None
        if use_somatosensory_feedback:
            self.best_synthesis_somatosensory = None
        #: per-phase wall-clock split of the most recent plan_resynth or
        #: parallel.batched.plan_batch_resynth
        self.last_planning_timings = None

    def close(self):
        self._executor.shutdown(wait=True)
        self.synth_pool.close()

    # ------------------------------------------------------------------
    # weights and state
    # ------------------------------------------------------------------

    @staticmethod
    def _resolve_weights(pretrained_dir):
        """-> {model key: JAX-layout tree} of the weights that
        ``pretrained_dir`` names; a missing key means a random
        initialisation.  ``None`` without an available release (or under
        ``PAULE_TPU_NO_RELEASE=1``) gives ``{}`` and a one-time hint
        (``paule_tpu/api.py:322-343``)."""
        if pretrained_dir == "random":
            return {}
        if pretrained_dir is None:
            if REL.release_available():
                return REL.load_release()[0]
            REL.print_fallback_hint_once()
            return {}
        if not os.path.isdir(pretrained_dir):
            raise FileNotFoundError(
                f"pretrained_dir {pretrained_dir!r} does not exist")
        found = {}
        for key, (kind, subdir, name_filter) in PRETRAINED.items():
            d = os.path.join(pretrained_dir, subdir)
            if not os.path.isdir(d):
                continue
            files = sorted(f for f in os.listdir(d) if f.endswith(".pt")
                           and (name_filter is None or name_filter in f))
            if not files:
                continue
            path = os.path.join(d, files[0])
            try:
                found[key] = TC.convert(kind, path)
            except (OSError, RuntimeError, KeyError, ValueError,
                    pickle.UnpicklingError) as exc:
                # as the JAX package: the model falls back to random
                print(f"could not convert {path}: {exc}")
        return found

    def _model(self, module, injected, tree):
        """``module`` on the device, filled from the injected tree, else
        from ``tree``, else from the seeded random initialisation; in eval
        mode."""
        tree = injected if injected is not None else tree
        if tree is None:
            module.to(device=self.device, dtype=self.dtype)
            init_random(module, self.generator)
        else:
            load_into(module, tree, device=self.device, dtype=self.dtype)
        return module.eval()

    def save_state(self, path):
        """Write the models' parameters, the trainers' Adam states, the
        random generator's state and the replay buffer to one file
        (:mod:`paule_tpu_torch.checkpoint`)."""
        CK.save(path, CK.paule_state(self))

    def load_state(self, path):
        """Restore a file written by :meth:`save_state`; -> ``self``."""
        CK.restore_paule_state(self, CK.load(path))
        return self

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _tensor(self, x):
        """A copy of ``x`` on the device (never a view of a numpy array
        that the caller keeps)."""
        return torch.tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)

    def _embed(self, mel):
        """The embedder's semvecs ``(B, 300)`` of the mels ``(B, T, 60)``, a
        tensor on the device."""
        with torch.no_grad():
            return self.embedder(mel)

    def _models(self):
        """The planning models, as :mod:`.planning.engine` takes them."""
        return engine.Models(self.pred_model, self.embedder,
                             self.speech_classifier, self.cp_tube_model,
                             self.tube_mel_model, self.tube_embedder,
                             self.tube_generator)

    def _noise(self):
        """The generators' noise ``(1, 1, 100)``: drawn in float64 from
        :attr:`generator` on the CPU, then cast and moved to the device, so
        that a seed gives the same noise on every device."""
        noise = torch.randn((1, 1, 100), generator=self.generator,
                            dtype=torch.float64)
        return noise.to(device=self.device, dtype=self.dtype)

    def _generate(self, gen, length, semvec):
        """``gen`` (a :class:`Generator`) at ``length`` steps from fresh
        noise and ``semvec (1, 300)`` on the device -> ``(1, length, C)``."""
        noise = self._noise()
        with torch.no_grad():
            return gen(noise, int(length), semvec.reshape(1, 300))

    def _speak(self, cp_norm):
        """One normalised trajectory ``(T, 30)`` through the plant ->
        ``(audio, sr, tube)``: under the somatosensory variant through
        ``plant.speak_and_extract_tube_information``, ``tube`` the
        normalised ``(T, 10)`` (else ``None``); a non-finite trajectory,
        audio or tube raises (``paule_tpu/api.py:582-611``)."""
        cps = inv_normalize_cp(np.asarray(cp_norm, dtype=np.float64))
        if not np.isfinite(cps).all():
            raise ValueError("non-finite cp trajectory (planning diverged?)")
        tube = None
        if self.use_somatosensory_feedback:
            sig, sr, tube_info = self.plant.speak_and_extract_tube_information(
                cps)
            tube = synth.tube_features(tube_info)
        else:
            sig, sr = self.plant.speak(cps)
        if not np.isfinite(sig).all():
            raise ValueError("synthesizer produced non-finite audio")
        if tube is not None and not np.isfinite(tube).all():
            raise ValueError("synthesizer produced non-finite tube data")
        return np.asarray(sig, dtype=np.float64), sr, tube

    def _silence(self, i, why, n_frames):
        """The stand-in for snapshot ``i`` of ``n_frames`` cp frames, whose
        synthesis failed, under ``synthesis_error="skip"``: silence, and a
        zero tube under the somatosensory variant."""
        print(f"WARNING: synthesis of snapshot {i} failed ({why}); "
              "substituting silence")
        tube = (np.zeros((n_frames, 10)) if self.use_somatosensory_feedback
                else None)
        return np.zeros(max(0, n_frames - 1) * synth.FRAME_STEPS), tube

    @property
    def _plant_has_batch(self):
        """Whether the plant has the batch entry point the variant calls
        (``paule_tpu/api.py:570-580``)."""
        return hasattr(self.plant, "speak_and_extract_batch"
                       if self.use_somatosensory_feedback else "speak_batch")

    def _synthesize(self, snapshots, first=0):
        """Normalised cp ``(L, T, 30)`` -> audio ``(L, n)``, sr, and the
        normalised tubes ``(L, T, 10)`` under the somatosensory variant
        (else ``None``): one batch call when the plant has it, else one
        call per trajectory; a failed snapshot raises, or becomes silence
        (``paule_tpu/api.py:582-656``, ``:1153-1194``).  Messages number
        the snapshots from ``first``."""
        snapshots = np.asarray(snapshots, dtype=np.float64)
        n_frames = snapshots.shape[1]
        somato = self.use_somatosensory_feedback
        sigs, tubes = [], []
        if self.synthesis_async and self._plant_has_batch:
            cps = inv_normalize_cp(snapshots)
            if somato:
                audio, sr, errors, infos = self.plant.speak_and_extract_batch(
                    cps)
            else:
                audio, sr, errors = self.plant.speak_batch(cps)
            for i, sig in enumerate(audio, first):
                tube = None
                bad = errors[i - first] != 0 or not np.isfinite(sig).all()
                if not bad and somato:
                    tube = synth.tube_features(infos[i - first])
                    bad = not np.isfinite(tube).all()
                if bad:
                    why = f"error code {int(errors[i - first])}"
                    if self.synthesis_error == "raise":
                        raise ValueError(
                            f"synthesis of snapshot {i} failed ({why}; -1 = "
                            "non-finite trajectory, planning diverged?)")
                    sig, tube = self._silence(i, why, n_frames)
                sigs.append(sig)
                tubes.append(tube)
        else:
            for i, snapshot in enumerate(snapshots, first):
                try:
                    sig, sr, tube = self._speak(snapshot)
                except Exception as exc:  # noqa: BLE001  (the policy decides)
                    if self.synthesis_error == "raise":
                        raise
                    sig, tube = self._silence(i, exc, n_frames)
                    sr = synth.SAMPLE_RATE
                sigs.append(sig)
                tubes.append(tube)
        return np.stack(sigs), sr, np.stack(tubes) if somato else None

    def _prod_metrics(self, sigs, snapshots, prod_tubes, target_mel,
                      target_semvec, want_semvec, fetch=True):
        """Produced-audio metrics of all logged snapshots in one batch, the
        models in eval mode (``paule_tpu/api.py:453-512``): mels, mel
        losses and, with ``want_semvec``, semvecs and their losses; the
        classifier's loss; under the somatosensory variant the cp->tube
        model's tubes of the ``snapshots`` (on the device) and their loss
        against the produced ``prod_tubes``, both tubes' tube->mel mels,
        the produced one's mel loss and, with ``want_semvec``, the tube
        embedder's semvec of the produced tubes and its loss.  -> (those
        as float64 numpy, or as tensors on the device unless ``fetch``,
        {"prod_mel", "prod_tube"} on the device, which continue-learning
        trains on)."""
        with torch.no_grad():
            prod_mel = normalize_mel(melspec_44100(self._tensor(sigs)))
            out = {"prod_mel": prod_mel,
                   "prod_loss": MEL_WEIGHT * rmse_rows(prod_mel,
                                                       target_mel)}
            dev = {"prod_mel": prod_mel, "prod_tube": None}
            if want_semvec:
                prod_semvec = self.embedder(prod_mel)
                out["prod_semvec"] = prod_semvec
                out["prod_semvec_loss"] = SEMANTIC_WEIGHT * rmse_rows(
                    prod_semvec, target_semvec)
            if self.use_speech_classifier:
                logits = self.speech_classifier(prod_mel)[:, None]
                out["prod_sc_loss"] = SPEECH_CLASSIFIER_WEIGHT * (
                    L.bce_with_logits(logits, torch.zeros_like(logits),
                                      dim=1))
            if self.use_somatosensory_feedback:
                tubes = dev["prod_tube"] = self._tensor(prod_tubes)
                pred_tube = self.cp_tube_model(snapshots)
                out["pred_tube"] = pred_tube
                out["prod_tube_mel"] = self.tube_mel_model(tubes)
                out["pred_tube_mel"] = self.tube_mel_model(pred_tube)
                out["prod_tube_loss"] = rmse_rows(pred_tube, tubes)
                out["prod_tube_mel_loss"] = TUBE_MEL_WEIGHT * rmse_rows(
                    out["prod_tube_mel"], target_mel)
                if want_semvec:
                    semvec = self.tube_embedder(tubes)
                    out["prod_tube_semvec"] = semvec
                    out["prod_tube_semvec_loss"] = (
                        TUBE_SEMANTIC_WEIGHT * rmse_rows(semvec,
                                                         target_semvec))
        return ({k: _np(v) for k, v in out.items()} if fetch else out), dev

    def create_epoch_batches(self, df_length, batch_size, shuffle=True,
                             same_size_batching=False,
                             sorted_training_length_keys=None,
                             training_length_dict=None):
        """Batch indices for one epoch, drawn from the instance's Python
        generator (``paule_tpu/api.py:666-674``)."""
        del sorted_training_length_keys
        return create_epoch_batches(
            df_length, batch_size, shuffle=shuffle,
            same_size_batching=same_size_batching,
            training_length_dict=training_length_dict, rng=self._py_rng)

    def _n_chunks(self):
        """The planning chunks per outer iteration that ``plan_overlap``
        asks for (1: no overlap); none without ``synthesis_async``."""
        if not self.synthesis_async or not self.plan_overlap:
            return 1
        return 2 if self.plan_overlap is True else int(self.plan_overlap)

    def _plan(self, models, xx, optimizer, chunks, target_mel, target_semvec,
              *, objective, constraints, log_ii, want_semvec, log_gradients,
              verbose):
        """One outer iteration's planning of the leaf ``xx``, in ``chunks``
        (:func:`overlap_chunks`), every chunk's constraints anchored to the
        trajectory at the iteration's start.  After each chunk its logs
        start their way to the host (:class:`_HostCopy`; without blocking
        the host under ``async_chunk_fetch``) and, with more than one chunk,
        the synthesis of its snapshots is submitted to the executor, to run
        while the host queues the next chunks.  The semvecs of the logged
        mels that only ``log_semantics`` asks for are embedded once, after
        the last chunk, as one segment would.  -> (the logged snapshots
        ``(L, T, 30)`` on the device, the host copies, the synthesis
        futures)."""
        overlap = len(chunks) > 1
        xx_start = xx.detach().clone()
        fetches, jobs, snaps, mels = [], [], [], []
        for c0, c1 in chunks:
            seg = engine.plan_segment(
                models, xx, optimizer, target_mel, target_semvec,
                n_steps=c1 - c0, objective=objective, log_semantics=False,
                constraints=constraints, log_every=log_ii, xx_start=xx_start)
            semvec = seg["pred_semvec"]
            fetch = _HostCopy({
                "subs": torch.stack(list(seg["sub_losses"])),
                "xx_pre": seg["xx_pre"][:, 0],
                "pred_mel": seg["pred_mel"][:, 0],
                "pred_semvec": None if semvec is None else semvec[:, 0],
                "grads": seg["grads"] if log_gradients else None,
                "grad_max": seg["grad_max"] if verbose else None,
                "grad_min": seg["grad_min"] if verbose else None},
                non_blocking=overlap and self.async_chunk_fetch)
            if overlap:
                jobs.append(self._executor.submit(
                    lambda f=fetch, first=sum(len(x) for x in snaps):
                    self._synthesize(f.get("xx_pre"), first)))
            fetches.append(fetch)
            snaps.append(seg["xx_pre"][:, 0])
            mels.append(seg["pred_mel"])
        if want_semvec and semvec is None:
            semvecs = engine.embed_logged(models, torch.cat(mels))
            fetches.append(_HostCopy({"pred_semvec": semvecs[:, 0]},
                                     non_blocking=False))
        return torch.cat(snaps), fetches, jobs

    def plan_resynth(self, *, learning_rate_planning=0.01,
                     learning_rate_learning=0.001,
                     learning_rate_learning_inv=None,
                     target_acoustic=None, target_semvec=None,
                     target_seq_length=None, initial_cp=None, past_cp=None,
                     initialize_from="acoustic", objective="acoustic",
                     n_outer=5, n_inner=24, continue_learning=True,
                     continue_learning_inv=False,
                     continue_learning_tube=False,
                     add_training_data_pred=False,
                     add_training_data_inv=False,
                     n_batches=3, batch_size=8, n_epochs=10,
                     log_ii=1, log_semantics=True, log_gradients=False,
                     log_signals=False, log_cps=False, plot=False, seed=None,
                     verbose=True):
        """Plan a cp trajectory that resynthesises ``target_acoustic`` (a
        WAV path, ``(sig, sr)`` or a normalised target mel ``(T, 60)``), or,
        with ``target_acoustic=None``, the target mel the mel generator
        makes from noise and ``target_semvec`` at ``target_seq_length``
        frames (its audio, ``target_sig``, by Griffin-Lim); argument surface
        and results of ``paule_tpu.api.Paule.plan_resynth``.

        ``initialize_from="acoustic"`` starts from the inverse model's cp
        of the target mel, ``"semvec"`` from the cp generator's at twice
        the target's frames, from noise and the target semvec (given, or
        the embedder's of the target mel).

        With ``continue_learning``, each outer iteration then trains the
        predictive model (and, with ``continue_learning_inv``, the inverse
        model) for ``n_epochs`` on ``n_batches`` batches of ``batch_size``
        drawn from its logged snapshots and their produced mels, mixed
        half and half with replay rows when ``add_training_data_pred``
        (``add_training_data_inv``) is set and the replay buffer holds
        any.  With ``continue_learning_tube`` under the somatosensory
        variant, the cp->tube model is trained on (cp, produced tube) and
        the tube->mel model on (produced tube, produced mel) of the
        predictive model's rows.

        ``plot=True`` shows, and ``plot="<prefix>"`` writes to
        ``<prefix>_<outer iteration>.png``, the mel panels of
        :func:`~paule_tpu_torch.visualize.plot_mels` after each outer
        iteration that logged a step (``paule_tpu/api.py:1335-1345``).

        Returns :class:`PlanningResults`, or under a variant
        :class:`PlanningResultsWithSpeechClassifier` /
        :class:`PlanningResultsWithSomatosensory`."""
        if seed:
            self.generator.manual_seed(seed)
            self.tube_generator.manual_seed(seed)
            self._py_rng.seed(seed)
        if target_acoustic is None and target_semvec is None:
            raise ValueError(
                "Either target_acoustic or target_semvec has to be not None.")
        if objective not in engine.OBJECTIVES:
            raise ValueError("objective has to be one of 'acoustic_semvec', "
                             "'acoustic' or 'semvec'")
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
        want_semvec = objective != "acoustic" or log_semantics
        somato = self.use_somatosensory_feedback
        use_sc = self.use_speech_classifier

        # ---------------- target ----------------
        target_sig = target_sr = None
        if target_semvec is not None:
            target_semvec = np.asarray(target_semvec,
                                       dtype=np.float64).reshape(1, 300)
        if isinstance(target_acoustic, str) or (
                isinstance(target_acoustic, (tuple, list))
                and len(target_acoustic) == 2):
            target_sig, target_sr, mel = audio_target_to_mel(
                target_acoustic, device=self.device, dtype=self.dtype)
            target_mel = mel[None]
            target_seq_length = target_mel.shape[1]
        elif target_acoustic is not None:
            target_mel = np.asarray(target_acoustic, dtype=np.float64)
            if target_mel.ndim == 2:
                target_mel = target_mel[None]
            target_seq_length = target_mel.shape[1]
        elif target_seq_length is None:
            raise ValueError("if target_acoustic is None you need to give a "
                             "target_seq_length and a target_semvec")
        else:
            # the mel generator's target (paule_tpu/api.py:759-767); the
            # mel is not min-shifted, unlike an audio target's
            target_mel = _np(self._generate(
                self.mel_gen_model, target_seq_length,
                self._tensor(target_semvec)))
            target_sig, target_sr = mel_to_sig(
                target_mel[0], device=self.device, dtype=self.dtype)
        target_mel_dev = self._tensor(target_mel)
        if target_semvec is None:
            target_semvec_dev = self._embed(target_mel_dev)
        else:
            target_semvec_dev = self._tensor(target_semvec)

        # ---------------- cp initialisation ----------------
        if initial_cp is None:
            if initialize_from == "acoustic":
                with torch.no_grad():
                    cp = self.inv_model(target_mel_dev)
                initial_cp = np.clip(_np(cp)[0], -1.0, 1.0)
            elif initialize_from == "semvec":
                initial_cp = _np(self._generate(
                    self.cp_gen_model, 2 * int(target_seq_length),
                    target_semvec_dev))[0]
            else:
                raise ValueError(
                    "initialize_from has to be either 'acoustic' or 'semvec'")
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
        models = self._models()
        constraints = engine.Constraints(clamp=1.05, smiling=self.smiling,
                                         past_len=past_len)

        # ---------------- initial baseline ----------------
        with torch.no_grad():
            initial_pred_mel_dev = self.pred_model(xx)
            initial_pred_semvec = _np(self._embed(initial_pred_mel_dev))[0]
        initial_pred_mel = _np(initial_pred_mel_dev)[0]
        initial_sig, initial_sr, initial_prod_tube = self._speak(initial_cp)
        if somato:
            # the tube models on the initial trajectory and on its produced
            # tube (paule_tpu/api.py:851-866)
            with torch.no_grad():
                pred_tube = self.cp_tube_model(xx)
                prod_tube = self._tensor(initial_prod_tube[None])
                somato_init = {
                    "initial_prod_tube": initial_prod_tube,
                    "initial_pred_tube": pred_tube,
                    "initial_prod_tube_mel": self.tube_mel_model(prod_tube),
                    "initial_pred_tube_mel": self.tube_mel_model(pred_tube),
                    "initial_prod_tube_semvec": self.tube_embedder(
                        prod_tube),
                    "initial_pred_tube_semvec": self.tube_embedder(
                        pred_tube)}
            somato_init = {k: v if k == "initial_prod_tube" else _np(v)[0]
                           for k, v in somato_init.items()}
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
        if somato:
            self.best_synthesis_somatosensory = BestSynthesisSomatosensory(
                np.inf, np.inf, np.inf, initial_cp, initial_sig,
                *somato_init.values())

        # the series of paule_tpu/api.py:819-836
        logs = {k: [] for k in (
            "prod_loss_steps", "planned_loss_steps", "planned_mel_loss_steps",
            "vel_loss_steps", "jerk_loss_steps", "pred_semvec_loss_steps",
            "prod_semvec_loss_steps", "cp_steps", "pred_semvec_steps",
            "prod_semvec_steps", "grad_steps", "sig_steps", "prod_mel_steps",
            "pred_mel_steps", "pred_model_loss", "inv_model_loss")}
        if use_sc:
            logs["pred_speech_classifier_loss_steps"] = []
            logs["prod_speech_classifier_loss_steps"] = []
        if somato:
            for k in ("prod_tube_loss_steps", "pred_tube_mel_loss_steps",
                      "prod_tube_mel_loss_steps",
                      "pred_tube_semvec_loss_steps",
                      "prod_tube_semvec_loss_steps", "pred_tube_steps",
                      "prod_tube_steps", "prod_tube_mel_steps",
                      "pred_tube_mel_steps", "pred_tube_semvec_steps",
                      "prod_tube_semvec_steps", "tube_model_loss",
                      "tube_mel_model_loss"):
                logs[k] = []
        optimizer = engine.make_optimizer(xx, learning_rate_planning)
        n_segments = n_inner // log_ii
        chunks = overlap_chunks(n_inner, log_ii, self._n_chunks())
        sig, sr, prod_mel = initial_sig, initial_sr, initial_prod_mel
        prod_tube = initial_prod_tube
        timings = {"planning": 0.0, "synthesis": 0.0, "metrics": 0.0,
                   "continue_learning": 0.0}
        # (host copy of an iteration's produced metrics, what logs them),
        # flushed once the next iteration's planning is queued
        # (paule_tpu/api.py:1365-1400)
        defer = (self.defer_metrics_fetch and continue_learning
                 and n_segments > 0 and not verbose)
        deferred = []

        def flush():
            with _phase(timings, "metrics"):
                while deferred:
                    copy, finish = deferred.pop(0)
                    finish(copy.all())

        start = time.perf_counter()
        for ii_outer in range(n_outer):
            with _phase(timings, "planning"):
                snaps_dev, fetches, jobs = self._plan(
                    models, xx, optimizer, chunks, target_mel_dev,
                    target_semvec_dev, objective=objective,
                    constraints=constraints, log_ii=log_ii,
                    want_semvec=want_semvec, log_gradients=log_gradients,
                    verbose=verbose)
            flush()
            with _phase(timings, "planning"):
                host = _gather(fetches)
                subs = engine.SubLosses(*host["subs"])
                snapshots, pred_mels = host["xx_pre"], host["pred_mel"]
                pred_semvecs = host.get("pred_semvec")
                for s in range(n_segments):
                    logs["planned_loss_steps"].append(float(subs.total[s]))
                    logs["planned_mel_loss_steps"].append(
                        float(subs.mel_loss[s]))
                    logs["vel_loss_steps"].append(float(subs.velocity_loss[s]))
                    logs["jerk_loss_steps"].append(float(subs.jerk_loss[s]))
                    if want_semvec:
                        logs["pred_semvec_loss_steps"].append(
                            float(subs.semvec_loss[s]))
                    if use_sc:
                        logs["pred_speech_classifier_loss_steps"].append(
                            float(subs.speech_classifier_loss[s]))
                    if somato:
                        logs["pred_tube_mel_loss_steps"].append(
                            float(subs.tube_mel_loss[s]))
                        logs["pred_tube_semvec_loss_steps"].append(
                            float(subs.tube_semvec_loss[s]))
                    if log_gradients:
                        logs["grad_steps"].append(host["grads"][s])
                    if verbose:
                        if host["grad_max"][s] > 10:
                            print("WARNING: gradient is larger than 10")
                        if host["grad_min"][s] < -10:
                            print("WARNING: gradient is smaller than -10")
                        print(f"Iteration {s * log_ii + log_ii - 1}")
                        print("Planned Loss: ", float(subs.total[s]))
                        print("Mel Loss: ", float(subs.mel_loss[s]))
                        print("Vel Loss: ", float(subs.velocity_loss[s]))
                        print("Jerk Loss: ", float(subs.jerk_loss[s]))
                        print("Local Linear Loss: ",
                              float(subs.local_linear_loss[s]))

            with _phase(timings, "synthesis"):
                if jobs:
                    # what did not overlap the planning
                    parts = [job.result() for job in jobs]
                    sigs = np.concatenate([p[0] for p in parts])
                    sr = parts[-1][1]
                    prod_tubes = (np.concatenate([p[2] for p in parts])
                                  if somato else None)
                else:
                    sigs, sr, prod_tubes = self._synthesize(snapshots)
                sig = sigs[-1]
                if somato:
                    prod_tube = prod_tubes[-1]
                if log_signals:
                    logs["sig_steps"].extend(list(sigs))

            def finish(pm, snapshots=snapshots, sigs=sigs,
                       prod_tubes=prod_tubes, pred_mels=pred_mels,
                       pred_semvecs=pred_semvecs, ii_outer=ii_outer):
                """Log an iteration's produced metrics ``pm`` (host);
                bound to its own iteration's values, since a deferred call
                runs in the next one."""
                nonlocal prod_mel
                prod_mel = pm["prod_mel"][-1]
                self._log_produced(logs, pm, snapshots, sigs, prod_tubes,
                                   pred_mels, pred_semvecs, want_semvec,
                                   verbose)
                if log_cps:
                    logs["cp_steps"].append(list(snapshots))
                if plot and n_segments:
                    from . import visualize

                    visualize.plot_mels(
                        True if plot is True
                        else f"{plot}_{ii_outer:03d}.png",
                        target_mel[0], initial_pred_mel, initial_prod_mel,
                        pred_mels[-1], pm["prod_mel"][-1])

            with _phase(timings, "metrics"):
                pm_dev, prod_dev = self._prod_metrics(
                    sigs, snaps_dev, prod_tubes, target_mel_dev,
                    target_semvec_dev, want_semvec, fetch=False)
                copy = _HostCopy(pm_dev, non_blocking=defer)
                if defer:
                    deferred.append((copy, finish))
                else:
                    finish(copy.all())

            if continue_learning and n_segments:
                with _phase(timings, "continue_learning"):
                    self._continue_learning(
                        snaps_dev, prod_dev["prod_mel"],
                        prod_dev["prod_tube"], target_semvec_dev[0], logs,
                        continue_learning_inv=continue_learning_inv,
                        continue_learning_tube=(continue_learning_tube
                                                and somato),
                        add_training_data_pred=add_training_data_pred,
                        add_training_data_inv=add_training_data_inv,
                        n_batches=n_batches, batch_size=batch_size,
                        n_epochs=n_epochs, verbose=verbose)
        flush()

        # ---------------- final results ----------------
        with torch.no_grad():
            pred_mel_dev = self.pred_model(xx)
            pred_semvec = _np(self._embed(pred_mel_dev))[0]
            prod_semvec = _np(self._embed(self._tensor(prod_mel[None])))[0]
            if somato:
                # the tube models on the plan and on the last produced tube
                # (paule_tpu/api.py:1415-1449)
                pred_tube = self.cp_tube_model(xx)
                prod_tube_dev = self._tensor(prod_tube[None])
                somato_final = {
                    "prod_tube": prod_tube,
                    "pred_tube": _np(pred_tube)[0],
                    "prod_tube_mel": _np(self.tube_mel_model(
                        prod_tube_dev))[0],
                    "pred_tube_mel": _np(self.tube_mel_model(pred_tube))[0],
                    "prod_tube_semvec": _np(self.tube_embedder(
                        prod_tube_dev))[0],
                    "pred_tube_semvec": _np(self.tube_embedder(
                        pred_tube))[0]}
        timings["total"] = time.perf_counter() - start
        self.last_planning_timings = timings
        if verbose:
            print("phase timings (s):",
                  {k: round(v, 3) for k, v in timings.items()})
        head = (_np(xx)[0], initial_cp, initial_sig, initial_sr,
                initial_prod_mel, initial_pred_mel)
        target = (target_sig, target_sr, target_mel[0])
        prod_pred = (sig, sr, prod_mel, _np(pred_mel_dev)[0])
        semvecs = (initial_prod_semvec, initial_pred_semvec, prod_semvec,
                   pred_semvec)
        planned = [logs[k] for k in (
            "prod_loss_steps", "planned_loss_steps", "planned_mel_loss_steps",
            "vel_loss_steps", "jerk_loss_steps", "pred_semvec_loss_steps",
            "prod_semvec_loss_steps")]
        steps = [logs[k] for k in (
            "cp_steps", "pred_semvec_steps", "prod_semvec_steps",
            "grad_steps", "sig_steps", "prod_mel_steps", "pred_mel_steps")]
        model_losses = [logs["pred_model_loss"], logs["inv_model_loss"]]
        if use_sc:
            return PlanningResultsWithSpeechClassifier(
                *head, *target, *prod_pred, *semvecs, *planned,
                logs["pred_speech_classifier_loss_steps"],
                logs["prod_speech_classifier_loss_steps"], *steps,
                *model_losses)
        if somato:
            final = [somato_final[k] for k in (
                "prod_tube", "pred_tube", "prod_tube_mel", "pred_tube_mel")]
            tube_semvecs = [somato_init["initial_prod_tube_semvec"],
                            somato_init["initial_pred_tube_semvec"],
                            prod_semvec, pred_semvec,
                            somato_final["prod_tube_semvec"],
                            somato_final["pred_tube_semvec"]]
            return PlanningResultsWithSomatosensory(
                *head, *(somato_init[k] for k in (
                    "initial_prod_tube", "initial_pred_tube",
                    "initial_prod_tube_mel", "initial_pred_tube_mel")),
                *target, *prod_pred, *final, initial_prod_semvec,
                initial_pred_semvec, *tube_semvecs, *planned,
                *(logs[k] for k in (
                    "prod_tube_loss_steps", "pred_tube_mel_loss_steps",
                    "prod_tube_mel_loss_steps", "pred_tube_semvec_loss_steps",
                    "prod_tube_semvec_loss_steps")),
                *steps,
                *(logs[k] for k in (
                    "prod_tube_steps", "pred_tube_steps",
                    "prod_tube_mel_steps", "pred_tube_mel_steps",
                    "prod_tube_semvec_steps", "pred_tube_semvec_steps")),
                *model_losses, logs["tube_model_loss"],
                logs["tube_mel_model_loss"])
        return PlanningResults(*head, *target, *prod_pred, *semvecs,
                               *planned, *steps, *model_losses)

    def _log_produced(self, logs, pm, snapshots, sigs, prod_tubes, pred_mels,
                      pred_semvecs, want_semvec, verbose):
        """Log one outer iteration's produced-audio metrics ``pm`` (of
        :meth:`_prod_metrics`) and update the best syntheses
        (``paule_tpu/api.py:1221-1362``)."""
        somato = self.use_somatosensory_feedback
        prod_semvecs, prod_tube_semvecs = [], []
        for s in range(len(snapshots)):
            prod_loss = float(pm["prod_loss"][s])
            logs["prod_loss_steps"].append(prod_loss)
            if self.use_speech_classifier:
                sc_loss = float(pm["prod_sc_loss"][s])
                logs["prod_speech_classifier_loss_steps"].append(sc_loss)
                if verbose:
                    print("Produced Speech Classifier Loss: ", sc_loss)
            if somato:
                tube_loss = float(pm["prod_tube_loss"][s])
                tube_mel_loss = float(pm["prod_tube_mel_loss"][s])
                logs["prod_tube_loss_steps"].append(tube_loss)
                logs["prod_tube_mel_loss_steps"].append(tube_mel_loss)
            if verbose:
                print("Produced Mel Loss: ", prod_loss)
            new_ac = BestSynthesisAcoustic(
                prod_loss, snapshots[s], sigs[s], pm["prod_mel"][s],
                pred_mels[s])
            if self.best_synthesis_acoustic.mel_loss > new_ac.mel_loss:
                self.best_synthesis_acoustic = new_ac
            tube_semvec, tube_semvec_loss = None, np.inf
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
                if somato:
                    tube_semvec = pm["prod_tube_semvec"][s]
                    tube_semvec_loss = float(pm["prod_tube_semvec_loss"][s])
                    prod_tube_semvecs.append(tube_semvec)
                    logs["prod_tube_semvec_loss_steps"].append(
                        tube_semvec_loss)
            if somato:
                new_som = BestSynthesisSomatosensory(
                    tube_loss, tube_mel_loss, tube_semvec_loss, snapshots[s],
                    sigs[s], prod_tubes[s], pm["pred_tube"][s],
                    pm["prod_tube_mel"][s], pm["pred_tube_mel"][s],
                    tube_semvec, None)
                if self.best_synthesis_somatosensory.tube_loss > tube_loss:
                    self.best_synthesis_somatosensory = new_som
        logs["prod_mel_steps"].append(list(pm["prod_mel"]))
        logs["pred_mel_steps"].append(list(pred_mels))
        logs["pred_semvec_steps"].append(
            list(pred_semvecs) if want_semvec else [])
        logs["prod_semvec_steps"].append(prod_semvecs)
        if somato:
            logs["prod_tube_steps"].append(list(prod_tubes))
            for k in ("pred_tube", "prod_tube_mel", "pred_tube_mel"):
                logs[f"{k}_steps"].append(list(pm[k]))
            # as in the JAX package, the planned tube semvecs are not kept
            logs["pred_tube_semvec_steps"].append([])
            logs["prod_tube_semvec_steps"].append(prod_tube_semvecs)

    # ------------------------------------------------------------------
    # continue-learning
    # ------------------------------------------------------------------

    def _rows_on_device(self, rows):
        return [r.to(self.device, self.dtype) if torch.is_tensor(r)
                else self._tensor(r) for r in rows]

    def _continue_learning(self, snapshots, prod_mels, prod_tubes,
                           target_semvec, logs, *, continue_learning_inv,
                           continue_learning_tube, add_training_data_pred,
                           add_training_data_inv, n_batches, batch_size,
                           n_epochs, verbose):
        """Train on this outer iteration's pre-update snapshots
        ``(L, T, 30)``, the mels of the audio produced from them and, under
        the somatosensory variant, the produced tubes ``(L, T, 10)``, all on
        the device, then offer them to the replay buffer (counterpart of
        ``paule_tpu/api.py:1523-1693``, drawing from ``self._py_rng`` in
        the same order)."""
        n_prod = snapshots.shape[0]
        # the columns trained on; replay rows' tubes are read only for the
        # tube models, as in the JAX package
        produced = {"cp_norm": snapshots,
                    "melspec_norm_synthesized": prod_mels}
        if continue_learning_tube:
            produced["tube_norm"] = prod_tubes

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
            """-> {replay column: rows}: this iteration's rows, or half
            replay rows followed by half of them."""
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
                return {c: self._rows_on_device(old[c])
                        + [rows[i] for i in prod_idx]
                        for c, rows in produced.items()}
            want = batch_size * n_batches
            k = min(want, n_prod)
            if k < want:
                scarce("Produced training data\nNot enough data produced to "
                       f"fill {n_batches} batches...", k)
            idx = torch.as_tensor(self._py_rng.sample(range(n_prod), k),
                                  device=snapshots.device)
            return {c: rows[idx] for c, rows in produced.items()}

        train = dict(batch_size=batch_size, n_epochs=n_epochs,
                     rng=self._py_rng)
        rows = sample_training(add_training_data_pred)
        cps, mels = rows["cp_norm"], rows["melspec_norm_synthesized"]
        if not self.physical_forward:
            # the physical forward model has nothing to train; its rows
            # are drawn all the same (paule_tpu/api.py:1658-1662)
            logs["pred_model_loss"].extend(
                train_epochs(self.pred_trainer, cps, mels, **train))
        if continue_learning_tube:
            # the same rows (paule_tpu/api.py:1664-1669)
            tubes = rows["tube_norm"]
            logs["tube_model_loss"].extend(
                train_epochs(self.tube_trainer, cps, tubes, **train))
            logs["tube_mel_model_loss"].extend(
                train_epochs(self.tube_mel_trainer, tubes, mels, **train))
        if continue_learning_inv:
            rows = sample_training(add_training_data_inv)
            logs["inv_model_loss"].extend(train_epochs(
                self.inv_trainer, rows["melspec_norm_synthesized"],
                rows["cp_norm"], **train))
        self.continue_data.append({
            "vector": [target_semvec] * n_prod, "cp_norm": list(snapshots),
            "melspec_norm_synthesized": list(prod_mels),
            "tube_norm": ([None] * n_prod if prod_tubes is None
                          else list(prod_tubes)),
            "segment_data": [False] * n_prod})

    # ------------------------------------------------------------------
    # chunked planning
    # ------------------------------------------------------------------

    def plan_iterative(self, *, target_acoustic=None, target_semvecs=None,
                       target_seq_lengths=None, overlap=8, **kwargs):
        """Plan a long utterance in chunks, each conditioned on the last
        ``overlap`` cp frames of the one before (:mod:`.planning.iterative`,
        ``paule_tpu/api.py:1695-1705``).  -> ``(planned_cp, [results of
        each chunk])``."""
        return plan_iterative(self, target_acoustic=target_acoustic,
                              target_semvecs=target_semvecs,
                              target_seq_lengths=target_seq_lengths,
                              overlap=overlap, **kwargs)
