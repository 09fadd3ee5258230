"""Data parallelism over a device mesh (``paule_tpu_torch.parallel.mesh``)
against ``paule_tpu.parallel.mesh``: the mesh's shapes and errors, and
the batched planners sharded over ``devices=["cpu", "cpu"]`` (the sharded
code on one device: each shard its own leaf, Adam and model replica,
continue-learning's batches split and their gradients reduced) against the
unsharded port to 1e-10 and against JAX's planners on a ``make_mesh(2,
dp=2, tp=1)`` of the virtual CPU devices, in float64."""

import copy

import numpy as np
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.dsp.targets import normalized_target_mel
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu.parallel import batched as JB
from paule_tpu.parallel import mesh as JM
from paule_tpu_torch import experiments as TX
from paule_tpu_torch.api import Paule
from paule_tpu_torch.models.blocks import init_random
from paule_tpu_torch.models.forward import ForwardModel
from paule_tpu_torch.parallel import batched as TB
from paule_tpu_torch.parallel import mesh as TM
from test_torch_batched import _both, _compare_sub_losses
from torch_parity import CP_ATOL, LOSS_RTOL
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B = 4
#: sharded against unsharded, both the port in float64
SHARD_TOL = 1e-10
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def target_mels():
    """Normalised mels ``(B, 12, 60)`` of the audio of four seeded cp
    trajectories of 24 frames."""
    rng = np.random.default_rng(5)
    mels = []
    for _ in range(B):
        cp = np.clip(rng.normal(0, 0.1, (24, 30)).cumsum(0) * 0.1, -1, 1)
        mels.append(normalized_target_mel(*JS.speak(inv_normalize_cp(cp))))
    return np.stack(mels)


def test_make_mesh_shapes():
    """As ``tests/test_parallel.py:30-37``, over eight listed devices; no
    CUDA device gives no default mesh here; ``tp > 1`` makes the mesh
    JAX makes (its grid: ``tests/test_torch_tp.py``)."""
    devices = ["cpu"] * 8
    assert TM.make_mesh(8, devices=devices).shape == JM.make_mesh(8).shape
    assert TM.make_mesh(devices=devices, dp=8, tp=1).shape == {
        "dp": 8, "tp": 1}
    assert TM.make_mesh(2, devices=devices).shape == {"dp": 2, "tp": 1}
    with pytest.raises(ValueError):
        TM.make_mesh(8, dp=3, tp=2, devices=devices)
    with pytest.raises(ValueError):
        JM.make_mesh(8, dp=3, tp=2)
    assert TM.make_mesh(8, dp=4, tp=2, devices=devices).shape == dict(
        JM.make_mesh(8, dp=4, tp=2).shape) == {"dp": 4, "tp": 2}
    assert TM.Mesh(devices, dp=4, tp=2).row(3) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no devices"):
            TM.make_mesh()


def test_shard_batch_and_replicate():
    """Contiguous shards, one per device; a module is its own replica on
    its device and a copy on another (``meta`` here); ``sync_replicas``
    copies the weights into the copies."""
    mesh = TM.make_mesh(devices=CPU2)
    x = torch.arange(12.0).reshape(4, 3)
    parts = TM.shard_batch(mesh, x)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:].tolist()]
    with pytest.raises(ValueError, match="dp=2"):
        TM.shard_batch(mesh, x[:3])
    model = ForwardModel(num_lstm_layers=1, hidden_size=8)
    init_random(model, torch.Generator().manual_seed(0))
    assert TM.replicate(mesh, model) == [model, model]
    assert TM.replicate(mesh, None) == [None, None]
    mixed = TM.make_mesh(devices=["cpu", "meta"])
    same, other = TM.replicate(mixed, model)
    assert same is model and other is not model
    assert next(other.parameters()).device.type == "meta"
    assert TM.replicate(TM.Mesh(["cpu"], dp=1), model) == [model]
    twin = ForwardModel(num_lstm_layers=1, hidden_size=8)
    TM.sync_replicas(model, [model, twin])
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)


def _close(out, ref, tol):
    """Every array and list of numbers in the results, to ``tol``
    absolutely."""
    assert sorted(out) == sorted(ref)
    for key, val in out.items():
        if key == "sub_losses":
            for a, b in zip(val if isinstance(val, list) else [val],
                            ref[key] if isinstance(val, list)
                            else [ref[key]]):
                for field in a._fields:
                    np.testing.assert_allclose(
                        getattr(a, field), getattr(b, field), rtol=0,
                        atol=tol, err_msg=field)
        else:
            np.testing.assert_allclose(np.asarray(val), np.asarray(ref[key]),
                                       rtol=0, atol=tol, err_msg=key)


def _port(init=None):
    return Paule(device="cpu", dtype=torch.float64, seed=7, **(init or {}))


def _run(fn, target_mels, mesh, init=None, **kw):
    port = _port(init)
    try:
        return fn(port, target_mels, mesh=mesh, **kw), port
    finally:
        port.close()


def test_plan_batch_sharded_equals_unsharded(target_mels):
    kw = dict(n_steps=3, objective="acoustic_semvec", log_semantics=True)
    one, _ = _run(TB.plan_batch, target_mels, None, **kw)
    two, _ = _run(TB.plan_batch, target_mels, TM.make_mesh(devices=CPU2),
                  **kw)
    _close(two, one, SHARD_TOL)


def _copying_replicate(mesh, module):
    """``replicate`` with a copy of ``module`` for every shard but the
    first, also on the module's own device."""
    if module is None:
        return [None] * len(mesh.devices)
    return [module] + [copy.deepcopy(module) for _ in mesh.devices[1:]]


@pytest.mark.parametrize("batch_size,replicas", [
    (2, "shared"), (3, "shared"), (2, "copies"), (3, "copies")])
def test_plan_batch_resynth_sharded_equals_unsharded(
        target_mels, batch_size, replicas, monkeypatch):
    """With continue-learning: batches of 2 train sharded; of 3 and 1 (not
    divisible by dp=2) on the primary copy, the replicas then synced.  With
    ``"copies"`` the second shard plans and trains on a copy of every model
    (as on a second device): its gradients are reduced into the primary
    copy and it takes the new weights after every step, so the next outer
    iteration plans against the trained model."""
    if replicas == "copies":
        monkeypatch.setattr(TM, "replicate", _copying_replicate)
    kw = dict(n_outer=2, n_inner=3, objective="acoustic_semvec",
              continue_learning=True, n_epochs=2, batch_size=batch_size)
    one, p1 = _run(TB.plan_batch_resynth, target_mels, None, **kw)
    two, p2 = _run(TB.plan_batch_resynth, target_mels,
                   TM.make_mesh(devices=CPU2), **kw)
    _close(two, one, SHARD_TOL)
    assert p1.pred_trainer.steps == p2.pred_trainer.steps == len(
        one["pred_model_loss"])
    for a, b in zip(p1.pred_model.parameters(), p2.pred_model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=SHARD_TOL)


def test_somatosensory_sharded_equals_unsharded(target_mels):
    """The tube embedder's dropout (0.7) masks of the whole batch are drawn
    as one device draws them and split over the shards; the tube models
    train sharded."""
    init = {"use_somatosensory_feedback": True}
    kw = dict(n_outer=2, n_inner=2, objective="acoustic_semvec",
              continue_learning=True, continue_learning_tube=True,
              n_epochs=1, batch_size=2)
    one, _ = _run(TB.plan_batch_resynth, target_mels, None, init, **kw)
    two, _ = _run(TB.plan_batch_resynth, target_mels,
                  TM.make_mesh(devices=CPU2), init, **kw)
    _close(two, one, SHARD_TOL)


def test_sharded_matches_jax_mesh(target_mels):
    """JAX's ``plan_batch_resynth`` sharded over ``make_mesh(2, dp=2,
    tp=1)`` of the virtual CPU devices against the port's over
    ``["cpu", "cpu"]``, at ``tests/test_torch_batched.py``'s tolerances."""
    jpaule, port = _both()
    kw = dict(n_outer=2, n_inner=3, objective="acoustic_semvec",
              continue_learning=True, n_epochs=2, batch_size=2)
    ref = JB.plan_batch_resynth(jpaule, target_mels,
                                mesh=JM.make_mesh(2, dp=2, tp=1), **kw)
    try:
        out = TB.plan_batch_resynth(port, target_mels,
                                    mesh=TM.make_mesh(2, devices=CPU2), **kw)
    finally:
        port.close()
    np.testing.assert_allclose(out["planned_cp"], ref["planned_cp"], rtol=0,
                               atol=CP_ATOL)
    for key in ("prod_loss_curve", "prod_semvec_loss_curve",
                "pred_model_loss"):
        np.testing.assert_allclose(out[key], np.asarray(ref[key]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=key)
    _compare_sub_losses(out["sub_losses"], ref["sub_losses"])


def test_corpus_leftover_batch_runs_unsharded(target_mels, monkeypatch):
    """Three utterances of one length at ``max_batch=2``: the batch of 2 is
    sharded over dp=2, the leftover of 1 runs with ``mesh=None``, and the
    results equal the unsharded corpus run's."""
    meshes = []
    real = TB.plan_batch_resynth

    def recording(paule, mels, *args, mesh=None, **kwargs):
        meshes.append((len(mels), mesh))
        return real(paule, mels, *args, mesh=mesh, **kwargs)

    monkeypatch.setattr(TB, "plan_batch_resynth", recording)
    kw = dict(max_batch=2, verbose=False, plan_kwargs=dict(
        n_outer=1, n_inner=2, continue_learning=True, n_epochs=1,
        batch_size=2))
    mesh = TM.make_mesh(devices=CPU2)
    out = {}
    for name, m in (("one", None), ("two", mesh)):
        port = _port()
        try:
            out[name] = TX.plan_corpus_batched(port, list(target_mels[:3]),
                                               mesh=m, **kw)
        finally:
            port.close()
    assert meshes == [(2, None), (1, None), (2, mesh), (1, None)]
    for a, b in zip(out["two"], out["one"]):
        _close(a, b, SHARD_TOL)
