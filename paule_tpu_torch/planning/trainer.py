"""Continue-learning: online training of the predictive and inverse models
on the audio the synthesizer produced, same-size batching, and the replay
buffer (counterpart of ``paule_tpu/planning/trainer.py``).

* predictive model: RMSE(pred_mel, produced_mel);
* inverse model: ``cp_trajectory_loss`` (position + 3x velocity,
  acceleration and jerk);
* same-size batching buckets samples by sequence length; leftovers are
  padded by repeating their last frame;
* the replay buffer caps at 1000 rows by random resampling.

Batching and sampling draw from a Python ``random.Random`` passed in by
the caller, call for call as the JAX package draws, so that equal seeds
give equal batches.  Training runs eagerly, one Adam step per batch,
through the models' LSTM layers (the CUDA kernels B1/B2 for float32
tensors on the card).
"""

import random

import torch

from .. import tracing
from ..ops import losses as L
from ..ops.padding import pad_batch
from ..parallel.mesh import reduce_grads

#: the reference's replay columns (``paule_tpu/api.py:1549-1551``)
COLUMNS = ("vector", "cp_norm", "melspec_norm_synthesized", "tube_norm",
           "segment_data")

LOSSES = {
    "rmse": L.rmse,
    "cp_trajectory": lambda y_hat, y: L.cp_trajectory_loss(y_hat, y)[0],
}


def create_epoch_batches(df_length, batch_size, shuffle=True,
                         same_size_batching=False, training_length_dict=None,
                         rng=random):
    """Batch indices for one epoch (``paule_tpu/planning/trainer.py:28-68``).

    With ``same_size_batching``, each length's indices are shuffled and cut
    into full batches; the leftovers of all lengths (in ascending length)
    form the last batches, and the epoch's batch order is shuffled.
    Otherwise one shuffled index list is cut into batches, the last one
    filled up from its start ("rolling batching")."""
    if same_size_batching and training_length_dict is None:
        raise ValueError(
            "Dictionary containing indices of samples with corresponding "
            "length needed for same_size_batching!")
    if same_size_batching:
        epoch, leftovers = [], []
        for length in sorted(training_length_dict):
            idxs = [int(i) for i in training_length_dict[length]]
            rest = len(idxs) % batch_size
            rng.shuffle(idxs)
            epoch += [idxs[i * batch_size:(i + 1) * batch_size]
                      for i in range(len(idxs) // batch_size)]
            if rest > 0:
                leftovers += idxs[-rest:]
        rest = len(leftovers) % batch_size
        epoch += [leftovers[i * batch_size:(i + 1) * batch_size]
                  for i in range(len(leftovers) // batch_size)]
        if rest > 0:
            epoch.append(leftovers[-rest:])
        rng.shuffle(epoch)
        return epoch

    rest = df_length % batch_size
    idxs = list(range(df_length))
    if shuffle:
        rng.shuffle(idxs)
    if rest > 0:
        idxs += idxs[:batch_size - rest]
    return [idxs[i * batch_size:(i + 1) * batch_size]
            for i in range(len(idxs) // batch_size)]


def build_length_dict(lens):
    """length -> indices of the samples of that length."""
    out = {}
    for i, n in enumerate(lens):
        out.setdefault(int(n), []).append(i)
    return out


class ModelTrainer:
    """Adam (``optax.adam``'s update rule) on one model's parameters for one
    loss, ``"rmse"`` or ``"cp_trajectory"``.

    The optimizer state lives as long as the trainer, across calls, like
    the reference's persistent torch optimizers.  The model's parameters
    take gradients only inside :meth:`train_batch`: outside it they are
    frozen, so that planning through the same model computes no weight
    gradients.

    A model without parameters (the physical forward model) gets no
    optimizer (``optimizer`` is ``None``): a step computes the loss only,
    as an Adam step on the JAX package's empty parameter tree does.

    ``name`` labels the model's Adam steps in a traced call
    (:mod:`paule_tpu_torch.tracing`); the model's class name by default."""

    def __init__(self, model, *, loss="rmse", learning_rate=0.001,
                 name=None):
        if loss not in LOSSES:
            raise ValueError(f"loss must be one of {sorted(LOSSES)}, got "
                             f"{loss!r}")
        self.model = model.requires_grad_(False)
        self.loss_fn = LOSSES[loss]
        params = list(model.parameters())
        self.optimizer = torch.optim.Adam(
            params, lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8) if params else None
        #: Adam steps taken
        self.steps = 0
        self.name = name or type(model).__name__

    def set_learning_rate(self, lr):
        """Change the learning rate; the Adam moments are kept."""
        if lr is not None and self.optimizer is not None:
            self.optimizer.param_groups[0]["lr"] = lr

    def train_batch(self, batch_in, batch_out, *, replicas=None):
        """One Adam step on a batch; -> the loss, a detached tensor on the
        model's device (no host sync).

        With ``replicas`` the batch comes in shards: ``batch_in`` and
        ``batch_out`` are lists, and shard ``i`` is predicted by
        ``replicas[i]``, the model itself or a copy of it on the shard's
        device, whose LSTM layers may be split over devices
        (:func:`paule_tpu_torch.parallel.mesh.replicate` with ``tp > 1``).
        The loss of the whole batch is taken on the model's device, and
        the gradients that reach the copies are summed into the model's
        before the step, each block of a split layer into its columns;
        bringing the copies up to the new weights is the caller's
        (:func:`paule_tpu_torch.parallel.mesh.sync_replicas`)."""
        if replicas is None:
            replicas, batch_in, batch_out = ([self.model], [batch_in],
                                             [batch_out])
        if self.optimizer is None:
            with torch.no_grad():
                loss = self._loss(replicas, batch_in, batch_out,
                                  batch_out[0].device)
        else:
            loss = self._step(replicas, batch_in, batch_out)
        self.steps += 1
        return loss.detach()

    def _step(self, replicas, batch_in, batch_out):
        """:meth:`train_batch`'s Adam step; -> the loss."""
        params = self.optimizer.param_groups[0]["params"]
        copies = [r for r in dict.fromkeys(replicas) if r is not self.model]
        for r in (self.model, *copies):
            r.requires_grad_(True)
        try:
            loss = self._loss(replicas, batch_in, batch_out, params[0].device)
            loss.backward()
            reduce_grads(self.model, copies)
            self.optimizer.step()
            if tracing.ON:
                tracing.adam_step(self.name)
        finally:
            for r in (self.model, *copies):
                r.zero_grad(set_to_none=True)
                r.requires_grad_(False)
        return loss

    def _loss(self, replicas, batch_in, batch_out, device):
        """The loss of the shards' predictions, joined on ``device``,
        against their targets."""
        return self.loss_fn(
            torch.cat([r(x).to(device) for r, x in zip(replicas, batch_in)]),
            torch.cat([y.to(device) for y in batch_out]))


def train_epochs(trainer, inps, tgts, *, batch_size, n_epochs, rng=random,
                 exact_batch_only=False, progress=None):
    """Train for ``n_epochs`` with same-size batching; -> per-epoch mean
    losses (one host sync, at the end; ``nan`` for an epoch without a
    batch, as ``np.mean([])`` gives in the JAX package).

    ``inps`` and ``tgts`` are sequences of ``(T_i, C)`` tensors on the
    trainer's device (a stacked ``(N, T, C)`` tensor is one).  All epochs'
    batches are drawn from ``rng`` first; ``exact_batch_only`` then drops
    each epoch's short batches (``paule_tpu/planning/trainer.py:183-239``).
    When all samples have one length, each epoch runs its full batches
    before its leftover batches, as the JAX package's same-length path does
    (``paule_tpu/planning/trainer.py:257-301``); otherwise batches run in
    the epoch's order, padded by repeating the last frame.
    ``progress(epoch)`` is called after each epoch's steps are queued, with
    no host sync.  In a traced call the steps are the leaves ``batch``
    (drawing and selecting a batch), ``step`` (its Adam step) and, at the
    end, ``losses``."""
    if tracing.ON:
        tracing.leaf("batch")
    lens = [int(x.shape[0]) for x in inps]
    length_dict = build_length_dict(lens)
    plans = [create_epoch_batches(len(lens), batch_size,
                                  same_size_batching=True,
                                  training_length_dict=length_dict, rng=rng)
             for _ in range(n_epochs)]
    if exact_batch_only:
        plans = [[b for b in batches if len(b) == batch_size]
                 for batches in plans]
    same_len = (len(set(lens)) == 1
                and len({int(y.shape[0]) for y in tgts}) == 1)
    if same_len:
        all_in = inps if torch.is_tensor(inps) else torch.stack(list(inps))
        all_out = tgts if torch.is_tensor(tgts) else torch.stack(list(tgts))
    epoch_losses = []
    for epoch, batches in enumerate(plans):
        if same_len:
            batches = ([b for b in batches if len(b) == batch_size]
                       + [b for b in batches if len(b) != batch_size])
        losses = []
        for idx in batches:
            if tracing.ON:
                tracing.leaf("batch")
            if same_len:
                sel = torch.as_tensor(idx, device=all_in.device)
                if tracing.ON:
                    tracing.sent(sel)
                b_in, b_out = all_in[sel], all_out[sel]
            else:
                outs = [tgts[i] for i in idx]
                b_in = pad_batch([lens[i] for i in idx],
                                 [inps[i] for i in idx])
                b_out = pad_batch([o.shape[0] for o in outs], outs)
            if tracing.ON:
                tracing.leaf("step")
            losses.append(trainer.train_batch(b_in, b_out))
        epoch_losses.append(mean_or_nan(losses, inps[0].device))
        if progress is not None:
            progress(epoch)
    if tracing.ON:
        tracing.leaf("losses")
    losses = torch.stack(epoch_losses)
    if tracing.ON:
        tracing.fetched(losses)
    return losses.tolist()


def mean_or_nan(losses, device):
    """The float64 mean of a list of scalar tensors on ``device``, without
    a host sync; ``nan`` for an empty list."""
    if not losses:
        return torch.full((), float("nan"), dtype=torch.float64,
                          device=device)
    return torch.stack(losses).mean().to(torch.float64)


class ReplayBuffer:
    """Replay data for continue-learning, capped at :attr:`LIMIT` rows by
    random resampling (``paule_tpu/planning/trainer.py:321-356``).

    ``data`` is any mapping from the names in :data:`COLUMNS` to
    equal-length sequences (a pandas DataFrame is one); a missing column
    is filled with ``None``.  Rows are kept as plain lists.  A buffer
    constructed with ``data=None`` never accumulates: the reference
    discards produced rows then (``paule_tpu/api.py:80-86``)."""

    LIMIT = 1000

    def __init__(self, data=None, rng=random):
        self.rng = rng
        self.data = None
        if data is not None:
            present = {c: list(data[c]) for c in COLUMNS if c in data}
            if not present:
                raise ValueError(f"continue_data has none of the columns "
                                 f"{COLUMNS}")
            sizes = {len(v) for v in present.values()}
            if len(sizes) != 1:
                raise ValueError("continue_data columns differ in length")
            n = sizes.pop()
            self.data = {c: present.get(c, [None] * n) for c in COLUMNS}
            self._cap()

    def __len__(self):
        return 0 if self.data is None else len(self.data["cp_norm"])

    def _rows(self, idx):
        return {c: [v[i] for i in idx] for c, v in self.data.items()}

    def _cap(self):
        if len(self) > self.LIMIT:
            self.data = self._rows(self.rng.sample(range(len(self)),
                                                   self.LIMIT))

    def append(self, rows):
        """Add ``rows`` (a mapping of :data:`COLUMNS` to equal-length
        lists), then cap; a buffer constructed empty discards them.  A
        tensor row is stored as a copy of its own, so that a kept row does
        not hold on to the whole batch it was a view of."""
        if self.data is None:
            return
        for c in COLUMNS:
            self.data[c].extend(r.clone() if torch.is_tensor(r) else r
                                for r in rows[c])
        self._cap()

    def sample(self, k):
        """``k`` rows drawn without replacement, as a mapping of columns to
        lists."""
        return self._rows(self.rng.sample(range(len(self)), k))
