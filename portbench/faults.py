"""Faults planted in the timed path underneath a run, each a way in which
the cells' path can break: a planning or a training step that returns
its state unchanged, half of a training batch left out (the mean taken
over the rest), the audio altered where it is produced, and the
exchange between cards left out.  ``python -m portbench.calibrate
--fault <name>`` reads them at a cell's own size; the CPU tests plant
them at test size.  Each takes an object with ``setattr(obj, name,
value)``, such as pytest's ``monkeypatch`` or :class:`Patch`."""

import torch


class Patch:
    """``setattr`` that :meth:`undo` takes back."""

    def __init__(self):
        self._kept = []

    def setattr(self, obj, name, value):
        self._kept.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._kept:
            obj, name, value = self._kept.pop()
            setattr(obj, name, value)


def _frozen_optimizer(xx, lr):
    """Adam on the trajectory whose step leaves it unchanged."""
    opt = torch.optim.Adam([xx], lr=lr)
    opt.step = lambda *a, **k: None
    return opt


def plan_step_unchanged(mp):
    from paule_tpu_torch.planning import engine

    mp.setattr(engine, "make_optimizer", _frozen_optimizer)


def train_step_unchanged(mp):
    from paule_tpu_torch.planning.trainer import ModelTrainer

    def loss_only(self, replicas, batch_in, batch_out):
        with torch.no_grad():
            return self._loss(replicas, batch_in, batch_out,
                              batch_out[0].device)

    mp.setattr(ModelTrainer, "_step", loss_only)


def half_batch(mp):
    from paule_tpu_torch.planning.trainer import ModelTrainer

    full = ModelTrainer._loss

    def first_half(self, replicas, batch_in, batch_out, device):
        return full(self, replicas, [x[:max(1, len(x) // 2)] for x in
                                     batch_in],
                    [y[:max(1, len(y) // 2)] for y in batch_out], device)

    mp.setattr(ModelTrainer, "_loss", first_half)


def audio_altered(mp):
    from paule_tpu_torch.synth import SynthPool

    batch = SynthPool._batch

    def louder(self, cps_batch, with_tube):
        audio, sr, errors, tubes = batch(self, cps_batch, with_tube)
        return audio * (1.0 + 1e-3), sr, errors, tubes

    mp.setattr(SynthPool, "_batch", louder)


def exchange_left_out(mp):
    from paule_tpu_torch.parallel import mesh

    mp.setattr(mesh, "sync_replicas", lambda model, replicas: None)


#: the faults a cell on one card can have, by name
FAULTS = {"plan_step_unchanged": plan_step_unchanged,
          "train_step_unchanged": train_step_unchanged,
          "half_batch": half_batch,
          "audio_altered": audio_altered}
