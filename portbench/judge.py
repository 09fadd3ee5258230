"""The comparison that decides ``correct``.

A driver gathers, from what the timed path produced, one ``outputs``
dict per run:

- ``target_mels`` ``(N, F, 60)``: the program's target mels of the
  utterances checked, and ``init_cps`` ``(N, T, 30)``: its inverse-model
  starts;
- ``plan_cps`` ``(S + 1, N, T, 30)``: its trajectories before each of
  its first ``S`` planning steps and after the last, ``plan_updates``
  ``(S, N, T, 30)``: each step's change, ``plan_losses`` ``(S, N)``: its
  loss before each step, ``plan_grads`` ``(S, N, T, 30)`` or ``None``: its
  gradient at each step, all planned with the release's predictive
  weights; where the program logs them, ``adam_cps``, ``adam_grads`` and
  ``adam_updates``: the trajectories, gradients and changes of all its
  logged steps;
- ``snap_cps`` ``(M, T, 30)``, ``snap_audio`` ``(M, n)``,
  ``prod_loss`` and ``prod_semvec_loss`` ``(M,)``, ``snap_owner``
  ``(M,)`` and under the somatosensory variant ``snap_tubes`` ``(M, T,
  10)``: trajectories it synthesised, their audio, their produced-audio
  losses, the index of the utterance each was planned for, and their
  tubes;
- ``train``: ``{"state", "after_first", "after_last"}``: the predictive
  model's (weights, Adam state) before its first continue-learning step,
  after it and after the last step tapped; ``"rows"``: per step the
  indices of its rows in ``snap_cps``; ``"losses"``: per step its loss.
  The state before the first step has to be the release's with a fresh
  Adam (``start_state``, compared exactly); the reference trains from its
  own copy of the release.

``inputs`` holds what the benchmark made and handed to both sides: the
target audio ``target_sigs`` (one per utterance checked), ``checked``,
the planning steps ``0 .. S - 1`` at which the reference works the loss
and gradient out again, and, for the somatosensory variant,
``mask_seed``, the seed of the call whose tube embedder masks are
replayed.

Planning is followed step by step from the program's own trajectories:
the reference evaluates the criterion at the program's ``plan_cps`` and
works each step's update out from there, Adam over its own gradients
(``plan_step``), since two precisions part by 1e-3 to 1e-1 within a few
tens of Adam steps (PERF.md).  Where the program logs every step, Adam
over the program's own gradients is also followed through all of them
(``plan_adam``).

:func:`numbers` works each quantity out again with the reference
(:class:`Reference`, float64) and returns the gaps; :func:`control`
puts the reference in the program's place, its matrix products in TF32
and its elementwise arithmetic (Adam) in bfloat16, the precisions just
below the configuration's float32, and returns its ``outputs``.
"""

import contextlib

import numpy as np
import torch

from .plain import nets, plan, synth
from .plain.dsp import Mel
from .plain.tables import MEL_WEIGHT, SEMANTIC_WEIGHT


@contextlib.contextmanager
def tf32(on):
    """TF32 matmuls and convolutions on (or off) inside the block."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


class Reference:
    """The plain reference on ``device`` in ``dtype`` (``tf32_on``: allow
    TF32 in its matmuls and convolutions; ``adam_dtype``: Adam's
    arithmetic, default ``dtype``)."""

    def __init__(self, arrays, somato, device, dtype=torch.float64,
                 tf32_on=False, adam_dtype=None):
        self.device, self.dtype, self.tf32 = device, dtype, tf32_on
        self.adam_dtype = adam_dtype or dtype
        self.somato = somato
        self.p = nets.weights(arrays, dtype, device)
        self.mel = Mel(device, dtype)

    def tensor(self, x):
        if torch.is_tensor(x):
            return x.detach().to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def run(self, fn, *args, **kw):
        with tf32(self.tf32), torch.no_grad():
            return fn(*args, **kw)

    def target_mels(self, sigs):
        return self.run(lambda: torch.stack([self.mel.target(s)
                                             for s in sigs]))

    def semvecs(self, mels):
        return self.run(nets.embedder, self.p, "embedder", self.tensor(mels))

    def inverse(self, mels):
        return self.run(lambda: nets.inverse_model(
            self.p, self.tensor(mels)).clamp(-1.0, 1.0))


    def masks(self, seed, shape, n):
        """The tube embedder's keep masks of the first ``n`` steps of a
        call seeded ``seed``, drawn as the program draws them: one
        ``(B, T, 720)`` uniform draw per step from a generator on the
        device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return [[torch.rand(shape[:2] + (720,), generator=gen,
                            device=self.device) >= plan.TUBE_DROPOUT]
                for _ in range(n)]

    def loss_grad(self, cps, target_mels, target_semvecs, keep_masks=None):
        """The criterion of each row of ``cps (N, T, 30)`` and its
        gradient."""
        x = self.tensor(cps).requires_grad_(True)
        with tf32(self.tf32):
            total = plan.criterion(self.p, x,
                                   self.tensor(target_mels),
                                   self.tensor(target_semvecs), self.somato,
                                   keep_masks)
            g, = torch.autograd.grad(total.sum(), x)
        return total.detach(), g

    def updates(self, base, grads, lr=0.01):
        """Each step's change of the trajectories ``base[k]`` under Adam
        over ``grads[0..k]`` with the clamp, in :attr:`adam_dtype`."""
        dt = self.adam_dtype
        m = v = None
        out = []
        for k, g in enumerate(grads):
            g = self.tensor(g).to(dt)
            x = self.tensor(base[k]).to(dt)
            if m is None:
                m, v = torch.zeros_like(g), torch.zeros_like(g)
            new, m, v = plan.adam(x, g, m, v, k + 1, lr)
            out.append(new.clamp(-plan.CLAMP, plan.CLAMP).to(self.dtype)
                       - x.to(self.dtype))
        return torch.stack(out)

    def prod_losses(self, audio, target_mels, target_semvecs):
        """-> (mel loss, semvec loss) of each produced signal against the
        targets (broadcast)."""
        def fn():
            mels = self.mel(audio)
            t_mel = self.tensor(target_mels)
            return (MEL_WEIGHT * plan.rmse_rows(mels, t_mel),
                    SEMANTIC_WEIGHT * plan.rmse_rows(
                        nets.embedder(self.p, "embedder", mels),
                        self.tensor(target_semvecs)))
        return self.run(fn)

    def train(self, cps, mels):
        """Continue-learning's steps on ``(cps, mels)`` from the release's
        weights and a fresh Adam: ``(losses, {leaf: first gradient},
        {leaf: change})``, the last two as float64 arrays."""
        batches = [(self.tensor(c), mel) for c, mel in zip(cps, mels)]
        with tf32(self.tf32):
            losses, first, change = plan.train_steps(self.p, None, batches)
        return (losses, {k: _np(g) for k, g in first.items()},
                {k: _np(d) for k, d in change.items()})


def _rel(a, b):
    """Largest ``|a - b| / |b|``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _rel_norm(a, b):
    """Largest ``|a_i - b_i| / |b_i|`` over the rows ``i`` of the leading
    two axes, in the L2 norm."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = np.sqrt(((a - b) ** 2).reshape(a.shape[:2] + (-1,)).sum(-1))
    ref = np.sqrt((b ** 2).reshape(b.shape[:2] + (-1,)).sum(-1))
    return float(np.max(diff / ref))


def _np(t):
    return t.detach().cpu().numpy().astype(np.float64)


def _norms(leaves):
    return {k: float(np.sqrt(np.sum(np.asarray(v, np.float64) ** 2)))
            for k, v in leaves.items()}


def _leaf_gaps(got, ref, keys=None):
    """Per leaf of ``keys``, the gap between the program's norm of the
    leaf and the reference's, over the reference's norm of that leaf or
    of the median leaf, whichever is larger (``None``: the leaves
    differ)."""
    a, r = _norms(got), _norms(ref)
    if set(a) != set(r):
        return None
    median = float(np.median(list(r.values())))
    return {k: abs(a[k] - r[k]) / max(r[k], median)
            for k in (r if keys is None else keys)}


def _training(train):
    """The program's readings of its tapped steps: ``(losses, {leaf: the
    first gradient, from Adam's first moment after one step}, {leaf: the
    change of the weights over the steps})``."""
    if "readings" in train:
        return train["readings"]
    w0, _ = train["state"]
    _, adam1 = train["after_first"]
    w1, _ = train["after_last"]
    first = {k: _np(m) / (1.0 - plan.BETAS[0])
             for k, (m, _v, _t) in adam1.items()}
    return (train["losses"], first,
            {k: _np(w1[k]) - _np(w0[k]) for k in w0})


def _start_gap(ref, state):
    """How far the state before the first tapped step lies from the
    release's weights with a fresh Adam: the largest difference of a
    weight, a moment or a step count."""
    weights, adam = state
    keys = {k for k in ref.p if k.startswith("predictive.")}
    if set(weights) != keys or set(adam) != keys:
        return float("inf")
    gaps = [float(np.max(np.abs(_np(w) - _np(ref.p[k]))))
            for k, w in weights.items()]
    gaps += [max(float(t), float(np.max(np.abs(_np(m)))),
                 float(np.max(np.abs(_np(v))))) for m, v, t in adam.values()]
    return max(gaps)


def _at_checked(ref, outputs, inputs, mels, semvecs):
    """``ref``'s losses ``(K, N)`` and gradients ``(K, N, T, 30)`` at the
    program's trajectories of the steps ``inputs["checked"]``."""
    cps = np.asarray(outputs["plan_cps"])
    checked = inputs["checked"]
    masks = (ref.masks(inputs["mask_seed"], cps.shape[1:3],
                       max(checked) + 1) if ref.somato else None)
    got = [ref.loss_grad(cps[k], mels, semvecs, masks[k] if masks else None)
           for k in checked]
    return torch.stack([g[0] for g in got]), torch.stack([g[1] for g in got])


def _first_steps(inputs, outputs):
    if list(inputs["checked"]) != list(range(len(outputs["plan_updates"]))):
        raise ValueError("the checked steps must be the first steps")


def _targets(ref, inputs):
    mels = ref.target_mels(inputs["target_sigs"])
    return mels, ref.semvecs(mels)


def numbers(outputs, inputs, ref):
    """The gaps between ``outputs`` and the reference ``ref``:
    ``{name: value}``."""
    mels, semvecs = _targets(ref, inputs)
    out = {"target_mel": float(np.max(np.abs(
        np.asarray(outputs["target_mels"]) - _np(mels))))}
    out["init_cp"] = float(np.max(np.abs(
        np.asarray(outputs["init_cps"]) - _np(ref.inverse(mels)))))
    losses, grads = _at_checked(ref, outputs, inputs, mels, semvecs)
    checked = inputs["checked"]
    out["plan_loss"] = _rel(np.asarray(outputs["plan_losses"])[checked],
                            _np(losses))
    if outputs["plan_grads"] is not None:
        out["plan_grad"] = _rel_norm(
            np.asarray(outputs["plan_grads"])[checked], _np(grads))
    _first_steps(inputs, outputs)
    out["plan_step"] = _rel_norm(outputs["plan_updates"], _np(
        ref.updates(outputs["plan_cps"], grads)))
    if "adam_grads" in outputs:
        out["plan_adam"] = _rel_norm(outputs["adam_updates"], _np(
            ref.updates(outputs["adam_cps"], outputs["adam_grads"])))
    # every snapshot was planned towards its utterance's targets
    owner = np.asarray(outputs["snap_owner"])
    loss, sem_loss = ref.prod_losses(outputs["snap_audio"], mels[owner],
                                     semvecs[owner])
    out["prod_metrics"] = max(_rel(outputs["prod_loss"], _np(loss)),
                              _rel(outputs["prod_semvec_loss"],
                                   _np(sem_loss)))
    gaps, compared, tubes = [], 0, []
    for cps, audio in zip(outputs["snap_cps"], outputs["snap_audio"]):
        first, second, tube = synth.speak_twice(cps, ref.somato)
        tubes.append(tube)
        # the samples before the first frication noise: no synthesizer
        # history can change them
        diff = np.nonzero(first != second)[0]
        n = len(first) if len(diff) == 0 else int(diff[0])
        compared += n
        if n:
            gaps.append(np.max(np.abs(np.asarray(audio)[:n] - first[:n])))
    out["synthesis"] = float(max(gaps)) if gaps else float("nan")
    out["synthesis_samples"] = compared
    if ref.somato:
        out["tube"] = float(np.max(np.abs(np.asarray(outputs["snap_tubes"])
                                          - np.stack(tubes))))
    train = outputs["train"]
    out["start_state"] = _start_gap(ref, train["state"])
    prod_mels = ref.run(ref.mel, outputs["snap_audio"])
    cps = [np.asarray(outputs["snap_cps"])[rows] for rows in train["rows"]]
    ys = [prod_mels[list(rows)] for rows in train["rows"]]
    losses, first, change = _training(train)
    r_losses, r_first, r_change = ref.train(cps, ys)
    # the first step's loss: Adam's later steps turn gradients at rounding
    # level into steps of their own (PERF.md)
    out["train_loss"] = _rel(losses[:1], r_losses[:1])
    gaps = _leaf_gaps(first, r_first)
    out["train_grad"] = float("inf") if gaps is None else max(gaps.values())
    # leaves whose gradient is nought to rounding move by round-off alone
    g = _norms(r_first)
    floor = 1e-3 * float(np.median(list(g.values())))
    gaps = _leaf_gaps(change, r_change, [k for k in g if g[k] >= floor])
    out["train_change"] = (float("inf") if gaps is None else
                           float(np.median(list(gaps.values()))))
    return out


def control(outputs, inputs, ctrl):
    """The reference ``ctrl`` (TF32 matmuls, bfloat16 Adam) in the
    program's place: its ``outputs`` for the same inputs, trajectories and
    rows."""
    mels, semvecs = _targets(ctrl, inputs)
    losses, grads = _at_checked(ctrl, outputs, inputs, mels, semvecs)
    checked = inputs["checked"]
    plan_losses = np.full(np.shape(outputs["plan_losses"]), np.nan)
    plan_losses[checked] = _np(losses)
    plan_grads = None
    if outputs["plan_grads"] is not None:
        plan_grads = np.zeros(np.shape(outputs["plan_grads"]))
        plan_grads[checked] = _np(grads)
    _first_steps(inputs, outputs)
    audio = np.stack([synth.speak(c) for c in outputs["snap_cps"]]).astype(
        np.float32).astype(np.float64)
    owner = np.asarray(outputs["snap_owner"])
    loss, sem_loss = ctrl.prod_losses(audio, mels[owner], semvecs[owner])
    out = dict(outputs, target_mels=_np(mels),
               init_cps=_np(ctrl.inverse(mels)), plan_losses=plan_losses,
               plan_grads=plan_grads, plan_updates=_np(ctrl.updates(
                   outputs["plan_cps"], grads)),
               snap_audio=audio, prod_loss=_np(loss),
               prod_semvec_loss=_np(sem_loss))
    if "adam_grads" in outputs:
        out["adam_updates"] = _np(ctrl.updates(outputs["adam_cps"],
                                               outputs["adam_grads"]))
    if ctrl.somato:
        out["snap_tubes"] = np.stack([
            synth.speak_twice(c, True)[2] for c in outputs["snap_cps"]
        ]).astype(np.float32).astype(np.float64)
    train = outputs["train"]
    prod_mels = ctrl.run(ctrl.mel, audio)
    cps = [np.asarray(outputs["snap_cps"])[rows] for rows in train["rows"]]
    ys = [prod_mels[list(rows)] for rows in train["rows"]]
    out["train"] = dict(train, readings=ctrl.train(cps, ys))
    return out
