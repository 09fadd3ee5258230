"""What the benchmark takes from the system under test, the
``paule_tpu_torch`` package: the ``Paule`` instance it builds from the
release's arrays, the release's weights put back into a trainer after
the warm-up, and taps that copy a trainer's state and its first training
steps' inputs and losses as the timed path runs them.  Only the drivers
and the tests import this module."""

import numpy as np
import torch

#: release model key -> ``Paule`` keyword that injects its tree
INJECT = {"predictive": "pred_model", "inverse": "inv_model",
          "embedder": "embedder", "cp_gan": "cp_gen_model",
          "mel_gan": "mel_gen_model", "cp_tube": "cp_tube_model",
          "tube_mel": "tube_mel_model", "tube_embedder": "tube_embedder"}


def make_paule(config, trees, *, seed, device):
    """``Paule`` with the configuration's keywords and every model the
    configuration loads injected from ``trees`` (nothing read twice, no
    random initialisation)."""
    from paule_tpu_torch.api import Paule

    kw = {INJECT[k]: trees[k] for k in config["loaded"]}
    return Paule(pretrained_dir="random", seed=seed, device=device,
                 **config["paule"], **kw)


def ref_key(prefix, name):
    """A module's parameter name -> the release's path:
    ``lstm.0.w_ih`` -> ``<prefix>.lstm[0].w_ih``."""
    parts = []
    for part in name.split("."):
        if part.isdigit():
            parts[-1] += f"[{part}]"
        else:
            parts.append(part)
    return ".".join([prefix, *parts])


def trainer_state(trainer, prefix):
    """Copies of a ``ModelTrainer``'s weights and Adam state, by release
    path: ``({key: tensor}, {key: (exp_avg, exp_avg_sq, steps)})``."""
    weights, adam = {}, {}
    for name, p in trainer.model.named_parameters():
        key = ref_key(prefix, name)
        weights[key] = p.detach().clone()
        st = trainer.optimizer.state.get(p, {})
        adam[key] = ((st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
                      int(st["step"])) if st else
                     (torch.zeros_like(p), torch.zeros_like(p), 0))
    return weights, adam


def restore(trainer, prefix, arrays):
    """Put the release's ``arrays`` back into ``trainer``'s model and
    forget its Adam state, as a fresh ``Paule`` holds them: the warm-up's
    training leaves nothing behind for the window."""
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(torch.as_tensor(np.asarray(arrays[ref_key(prefix,
                                                              name)])))
    trainer.optimizer.state.clear()
    trainer.steps = 0


class TrainTap:
    """Wraps ``trainer.train_batch`` until :meth:`close`: copies the
    trainer's state before its call number ``start``, after that call and
    after call ``start + n - 1``, and the inputs and losses of calls
    ``start .. start + n - 1`` (no host sync)."""

    def __init__(self, trainer, prefix, start, n):
        self.trainer, self.prefix = trainer, prefix
        self.start, self.n = start, n
        self.calls = 0
        #: the state before the first tapped step, after it, after the last
        self.state = self.after_first = self.after_last = None
        self.inputs, self.losses = [], []
        self._train = trainer.train_batch
        trainer.train_batch = self

    def _after(self, i):
        if i == self.start + 1:
            self.after_first = trainer_state(self.trainer, self.prefix)
        if i == self.start + self.n:
            self.after_last = trainer_state(self.trainer, self.prefix)

    def __call__(self, batch_in, batch_out, **kw):
        i = self.calls
        self.calls += 1
        if i == self.start:
            self.state = trainer_state(self.trainer, self.prefix)
        self._after(i)
        loss = self._train(batch_in, batch_out, **kw)
        if self.start <= i < self.start + self.n:
            # a batch sharded over a mesh comes as one tensor per shard
            self.inputs.append(torch.cat([
                x.detach().to(loss.device) for x in batch_in])
                if isinstance(batch_in, (list, tuple))
                else batch_in.detach().clone())
            self.losses.append(loss)
        return loss

    def close(self):
        self._after(self.calls)
        del self.trainer.train_batch

    def rows(self, cps):
        """The index in ``cps`` (host, ``(S, T, 30)``) of each row of each
        tapped step's input."""
        cps = np.asarray(cps)
        out = []
        for batch in self.inputs:
            rows = []
            for row in batch.double().cpu().numpy():
                hit = np.nonzero((cps == row).all(axis=(1, 2)))[0]
                if len(hit) == 0:
                    raise RuntimeError("a training row is none of the "
                                       "trajectories the step logged")
                rows.append(int(hit[0]))
            out.append(rows)
        return out

    def gathered(self, cps):
        """The ``train`` entry of the judge's ``outputs``."""
        return {"state": self.state, "after_first": self.after_first,
                "after_last": self.after_last, "rows": self.rows(cps),
                "losses": [float(x) for x in self.losses]}
