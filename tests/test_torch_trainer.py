"""The port's continue-learning pieces against ``paule_tpu.planning.trainer``
and the JAX losses and padding: batch index plans from equal
``random.Random`` seeds are identical; Adam steps of narrow models (H=16)
carried over with ``params_from_jax`` give the same parameters to 1e-8 in
float64; the replay buffer caps and samples the same rows."""

import copy
import random

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu.models import forward as JF
from paule_tpu.models import inverse as JI
from paule_tpu.ops import losses as JL
from paule_tpu.ops import padding as JP
from paule_tpu.planning import trainer as JT
from paule_tpu_torch.models.forward import ForwardModel
from paule_tpu_torch.models.inverse import InverseModelMelTimeSmoothResidual
from paule_tpu_torch.ops import losses as TL
from paule_tpu_torch.ops import padding as TP
from paule_tpu_torch.parallel import mesh as TM
from paule_tpu_torch.planning import trainer as TT
from paule_tpu_torch.release import load_into, params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-8
F64 = {"device": "cpu", "dtype": torch.float64}


def _as_lists(batches):
    return [[int(i) for i in b] for b in batches]


@pytest.mark.parametrize("n,batch_size,lens,same_size", [
    (24, 8, None, True),
    (9, 4, None, True),
    (13, 4, [40] * 5 + [30] * 6 + [50] * 2, True),
    (7, 3, [12, 12, 8, 8, 8, 20, 12], True),
    (10, 4, None, False),
    (8, 8, None, False),
])
def test_epoch_batches_match_jax(n, batch_size, lens, same_size):
    lens = lens or [16] * n
    ref_dict = JT.build_length_dict(lens)
    port_dict = TT.build_length_dict(lens)
    assert {k: list(map(int, v)) for k, v in ref_dict.items()} == port_dict
    r_ref, r_port = random.Random(3), random.Random(3)
    for _ in range(3):
        ref = JT.create_epoch_batches(
            n, batch_size, same_size_batching=same_size,
            training_length_dict=ref_dict, rng=r_ref)
        out = TT.create_epoch_batches(
            n, batch_size, same_size_batching=same_size,
            training_length_dict=port_dict, rng=r_port)
        assert _as_lists(out) == _as_lists(ref)
    assert r_ref.random() == r_port.random()


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(0)
    seqs = [rng.normal(size=(t, 5)) for t in (4, 7, 7, 1)]
    lens = [len(s) for s in seqs]
    ref = JP.pad_batch(lens, seqs)
    out = TP.pad_batch(lens, [torch.tensor(s) for s in seqs])
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="max_len"):
        TP.pad_batch([3], [torch.zeros(4, 2)])


def test_cp_trajectory_loss_matches_jax():
    rng = np.random.default_rng(1)
    y_hat, y = rng.normal(size=(2, 2, 20, 30)) * 0.3
    ref = JL.cp_trajectory_loss(jnp.asarray(y_hat), jnp.asarray(y))
    yt = torch.tensor(y_hat, requires_grad=True)
    out = TL.cp_trajectory_loss(yt, torch.tensor(y))
    np.testing.assert_allclose([float(v.detach()) for v in out],
                               [float(v) for v in ref], rtol=0, atol=1e-12)
    g_ref = jax.grad(lambda a: JL.cp_trajectory_loss(a, jnp.asarray(y))[0])(
        jnp.asarray(y_hat))
    out[0].backward()
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(g_ref), rtol=0,
                               atol=1e-12)


def _models(kind, seed=0):
    if kind == "forward":
        jm = JF.ForwardModel(num_lstm_layers=1, hidden_size=16)
        tm = ForwardModel(num_lstm_layers=1, hidden_size=16)
        loss, shapes = "rmse", ((12, 30), (6, 60))
    else:
        jm = JI.InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                                  hidden_size=16)
        tm = InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                               hidden_size=16)
        loss, shapes = "cp_trajectory", ((8, 60), (16, 30))
    params = jm.init(jax.random.PRNGKey(seed), jnp.float64)
    tm = load_into(tm, jax.tree.map(np.asarray, params), **F64)
    return (JT.ModelTrainer(jm, params, loss=loss),
            TT.ModelTrainer(tm, loss=loss), shapes)


def _assert_params_close(j_trainer, t_trainer):
    ref = params_from_jax(jax.tree.map(np.asarray, j_trainer.params))
    out = t_trainer.model.state_dict()
    assert ref.keys() == out.keys()
    for name, v in ref.items():
        np.testing.assert_allclose(out[name].numpy(), v.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kind", ["forward", "inverse"])
def test_model_trainer_matches_jax(kind):
    """Five Adam steps on the same batches, the learning rate changed after
    the second: the moments carry over, as in the JAX trainer."""
    j_tr, t_tr, (in_shape, out_shape) = _models(kind)
    rng = np.random.default_rng(2)
    for step in range(5):
        if step == 2:
            j_tr.set_learning_rate(0.004)
            t_tr.set_learning_rate(0.004)
        b_in = rng.normal(0, 0.3, (3,) + in_shape)
        b_out = rng.normal(0, 0.3, (3,) + out_shape)
        ref = float(j_tr.train_batch(b_in, b_out))
        out = t_tr.train_batch(torch.tensor(b_in), torch.tensor(b_out))
        np.testing.assert_allclose(float(out), ref, rtol=1e-10, atol=0)
    _assert_params_close(j_tr, t_tr)
    assert t_tr.steps == 5
    # outside a step the parameters are frozen and hold no gradient
    assert not any(p.requires_grad or p.grad is not None
                   for p in t_tr.model.parameters())


@pytest.mark.parametrize("kind", ["forward", "inverse"])
def test_sharded_train_batch_matches_jax(kind):
    """Three Adam steps on batches of 4 split into shards of 1 and 3, the
    second predicted by a copy of the model (as on a second device): the
    copy's gradients are summed into the model's, so the losses and the
    parameters equal the JAX trainer's on the whole batches; the copy,
    synced after each step, holds the same weights."""
    j_tr, t_tr, (in_shape, out_shape) = _models(kind)
    twin = copy.deepcopy(t_tr.model)
    rng = np.random.default_rng(3)
    for _ in range(3):
        b_in = rng.normal(0, 0.3, (4,) + in_shape)
        b_out = rng.normal(0, 0.3, (4,) + out_shape)
        ref = float(j_tr.train_batch(b_in, b_out))
        x, y = torch.tensor(b_in), torch.tensor(b_out)
        out = t_tr.train_batch([x[:1], x[1:]], [y[:1], y[1:]],
                               replicas=[t_tr.model, twin])
        np.testing.assert_allclose(float(out), ref, rtol=1e-10, atol=0)
        TM.sync_replicas(t_tr.model, [t_tr.model, twin])
    _assert_params_close(j_tr, t_tr)
    assert t_tr.steps == 3
    for a, b in zip(t_tr.model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    assert not any(p.requires_grad or p.grad is not None
                   for m in (t_tr.model, twin) for p in m.parameters())


@pytest.mark.parametrize("lens", [[12] * 9, [12] * 5 + [8] * 4])
def test_train_epochs_matches_jax(lens):
    """Leftover batches: same-length data runs each epoch's full batches
    first (the JAX same-length path); mixed lengths run padded batches in
    the epoch's order."""
    j_tr, t_tr, _ = _models("forward", seed=1)
    rng = np.random.default_rng(3)
    inps = [rng.normal(0, 0.3, (n, 30)) for n in lens]
    tgts = [rng.normal(0, 0.3, (n // 2, 60)) for n in lens]
    ref = JT.train_epochs(j_tr, inps, tgts, np.asarray(lens), batch_size=4,
                          n_epochs=3, rng=random.Random(7),
                          dtype=np.float64)
    out = TT.train_epochs(t_tr, [torch.tensor(x) for x in inps],
                          [torch.tensor(y) for y in tgts], batch_size=4,
                          n_epochs=3, rng=random.Random(7))
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=0)
    _assert_params_close(j_tr, t_tr)
    assert t_tr.steps == 3 * 3


@pytest.mark.parametrize("lens", [[12] * 9, [12] * 5 + [8] * 4])
def test_train_epochs_exact_batches_and_progress_match_jax(lens):
    """``exact_batch_only`` drops each epoch's short batches after the
    epoch's draw (the rng is consumed as without it); ``progress`` is
    called after each epoch."""
    j_tr, t_tr, _ = _models("forward", seed=1)
    rng = np.random.default_rng(3)
    inps = [rng.normal(0, 0.3, (n, 30)) for n in lens]
    tgts = [rng.normal(0, 0.3, (n // 2, 60)) for n in lens]
    r_ref, r_port = random.Random(7), random.Random(7)
    ref = JT.train_epochs(j_tr, inps, tgts, np.asarray(lens), batch_size=4,
                          n_epochs=3, rng=r_ref, dtype=np.float64,
                          exact_batch_only=True)
    seen = []
    out = TT.train_epochs(t_tr, [torch.tensor(x) for x in inps],
                          [torch.tensor(y) for y in tgts], batch_size=4,
                          n_epochs=3, rng=r_port, exact_batch_only=True,
                          progress=seen.append)
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=0)
    _assert_params_close(j_tr, t_tr)
    assert t_tr.steps == 3 * 2
    assert seen == [0, 1, 2]
    assert r_ref.random() == r_port.random()


def test_train_epochs_epoch_without_a_batch_is_nan():
    """Every batch short of ``batch_size`` and dropped: the epoch's loss is
    ``nan`` (``np.mean([])`` in the JAX package) and no step is taken."""
    _j, t_tr, _ = _models("forward", seed=2)
    x = [torch.zeros(12, 30, dtype=torch.float64)] * 3
    y = [torch.zeros(6, 60, dtype=torch.float64)] * 3
    out = TT.train_epochs(t_tr, x, y, batch_size=4, n_epochs=2,
                          rng=random.Random(0), exact_batch_only=True)
    assert np.isnan(out).all() and len(out) == 2 and t_tr.steps == 0


def test_train_epochs_takes_a_stacked_tensor():
    _j, a, _ = _models("forward", seed=2)
    _j, b, _ = _models("forward", seed=2)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(0, 0.3, (6, 12, 30)))
    y = torch.tensor(rng.normal(0, 0.3, (6, 6, 60)))
    kw = dict(batch_size=4, n_epochs=2)
    la = TT.train_epochs(a, x, y, rng=random.Random(1), **kw)
    lb = TT.train_epochs(b, list(x), list(y), rng=random.Random(1), **kw)
    assert la == lb


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="loss"):
        TT.ModelTrainer(ForwardModel(num_lstm_layers=1, hidden_size=4),
                        loss="l1")


def _frame(n, seed):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "vector": [rng.normal(size=3) for _ in range(n)],
        "cp_norm": [rng.normal(size=(4, 30)) for _ in range(n)],
        "melspec_norm_synthesized": [rng.normal(size=(2, 60))
                                     for _ in range(n)],
        "tube_norm": [None] * n, "segment_data": [False] * n})


def _same_rows(port_rows, ref_frame):
    assert len(port_rows["cp_norm"]) == len(ref_frame)
    for a, b in zip(port_rows["cp_norm"], ref_frame["cp_norm"]):
        np.testing.assert_array_equal(a, b)


def test_replay_buffer_matches_jax(monkeypatch):
    monkeypatch.setattr(JT.ReplayBuffer, "LIMIT", 10)
    monkeypatch.setattr(TT.ReplayBuffer, "LIMIT", 10)
    r_ref, r_port = random.Random(5), random.Random(5)
    ref = JT.ReplayBuffer(_frame(14, 0), rng=r_ref)
    out = TT.ReplayBuffer(_frame(14, 0), rng=r_port)
    assert len(out) == len(ref) == 10
    _same_rows(out.data, ref.data)
    for seed in (1, 2):
        ref.append(_frame(4, seed))
        out.append({k: list(v) for k, v in _frame(4, seed).items()})
        assert len(out) == len(ref) == 10
        _same_rows(out.data, ref.data)
    _same_rows(out.sample(6), ref.sample(6))
    assert r_ref.random() == r_port.random()


def test_replay_buffer_constructed_empty_never_accumulates():
    buf = TT.ReplayBuffer(None)
    buf.append({k: list(v) for k, v in _frame(3, 0).items()})
    assert len(buf) == 0 and buf.data is None
    grows = TT.ReplayBuffer({"cp_norm": []})
    grows.append({k: list(v) for k, v in _frame(3, 0).items()})
    assert len(grows) == 3 and grows.data["tube_norm"] == [None] * 3
    with pytest.raises(ValueError, match="columns"):
        TT.ReplayBuffer({"other": [1]})


def test_replay_buffer_copies_tensor_rows():
    """A kept row is a copy of its own, not a view holding its batch."""
    batch = torch.zeros(3, 5, 2)
    buf = TT.ReplayBuffer({"cp_norm": []})
    buf.append({c: list(batch) if c == "cp_norm" else [None] * 3
                for c in TT.COLUMNS})
    batch += 1
    for row in buf.data["cp_norm"]:
        assert row.untyped_storage().nbytes() == row.numel() * 4
        assert float(row.abs().max()) == 0.0
