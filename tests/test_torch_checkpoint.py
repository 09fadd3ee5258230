"""``save_state`` / ``load_state`` of the port (the counterpart of
``tests/test_checkpoint.py``): a round trip restores the parameters, Adam
states, random generator and replay buffer; a restored instance plans as
the saved one goes on planning, and as JAX's restored instance plans; the
file is read with ``weights_only=True``; a file that is not the port's
raises ``ValueError``."""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch import checkpoint as CK
from paule_tpu_torch.api import Paule
from torch_parity import CP_ATOL, LOSS_RTOL
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(n_outer=1, n_inner=2, n_batches=1, batch_size=2, n_epochs=1,
            log_ii=1, verbose=False)
F64 = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(scope="module")
def target():
    rng = np.random.default_rng(0)
    cp_true = np.clip(rng.normal(0, 0.1, (40, 30)).cumsum(0) * 0.1, -1, 1)
    return JS.speak(inv_normalize_cp(cp_true))


def _states_equal(a, b):
    """Whether two (nested) state dicts hold equal tensors and values."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_states_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_states_equal(x, y)
                                        for x, y in zip(a, b))
    return a == b


def _replay_frame(n_rows=3):
    return pd.DataFrame({
        "vector": [np.zeros(300)] * n_rows,
        "cp_norm": [np.zeros((40, 30))] * n_rows,
        "melspec_norm_synthesized": [np.zeros((20, 60))] * n_rows,
        "tube_norm": [None] * n_rows,
        "segment_data": [np.bool_(False)] * n_rows,
    })


def test_state_roundtrip(tmp_path, target):
    p = Paule(seed=5, **F64)
    q = Paule(seed=999, **F64)
    try:
        p.plan_resynth(target_acoustic=target, objective="acoustic",
                       continue_learning=True, continue_learning_inv=True,
                       **TINY)
        path = tmp_path / "ckpt.pt"
        p.save_state(path)
        assert not _states_equal(p.pred_model.state_dict(),
                                 q.pred_model.state_dict())
        assert q.load_state(path) is q
        for attr in ("pred_model", "inv_model", "embedder", "cp_gen_model",
                     "mel_gen_model"):
            assert _states_equal(getattr(p, attr).state_dict(),
                                 getattr(q, attr).state_dict()), attr
        for trainer in ("pred_trainer", "inv_trainer"):
            assert _states_equal(
                getattr(p, trainer).optimizer.state_dict(),
                getattr(q, trainer).optimizer.state_dict()), trainer
        assert torch.equal(p.generator.get_state(), q.generator.get_state())
        assert torch.equal(p._noise(), q._noise())
    finally:
        p.close()
        q.close()


def test_resumed_planning_matches(tmp_path, target):
    """A restored instance plans as the saved one goes on planning, and
    as the JAX package's restored instance plans."""
    first = dict(target_acoustic=target, objective="acoustic",
                 initialize_from="acoustic", continue_learning=True,
                 continue_learning_inv=True, **TINY)

    def resumed(r1):
        return dict(target_acoustic=target, objective="acoustic",
                    initial_cp=r1.planned_cp, initialize_from=None,
                    continue_learning=True, **TINY)

    p = Paule(seed=5, **F64)
    try:
        r1 = p.plan_resynth(**first)
        p.save_state(tmp_path / "ckpt.pt")
        ra = p.plan_resynth(**resumed(r1))
    finally:
        p.close()
    q = Paule(seed=5, **F64).load_state(tmp_path / "ckpt.pt")
    try:
        rb = q.plan_resynth(**resumed(r1))
    finally:
        q.close()
    np.testing.assert_array_equal(ra.planned_cp, rb.planned_cp)
    np.testing.assert_array_equal(ra.planned_loss_steps,
                                  rb.planned_loss_steps)
    np.testing.assert_array_equal(ra.pred_model_loss, rb.pred_model_loss)

    jp = JPaule(seed=5)
    jr1 = jp.plan_resynth(**first)
    jp.save_state(tmp_path / "ckpt.pkl")
    jq = JPaule(seed=5).load_state(tmp_path / "ckpt.pkl")
    jrb = jq.plan_resynth(**resumed(jr1))
    np.testing.assert_allclose(rb.planned_cp, jrb.planned_cp, rtol=0,
                               atol=CP_ATOL)
    for key in ("planned_loss_steps", "prod_loss_steps", "pred_model_loss"):
        np.testing.assert_allclose(getattr(rb, key), getattr(jrb, key),
                                   rtol=LOSS_RTOL, atol=0, err_msg=key)


def test_replay_buffer_saved(tmp_path):
    p = Paule(seed=5, continue_data=_replay_frame(), **F64)
    q = Paule(seed=6, **F64)
    try:
        p.save_state(tmp_path / "ckpt.pt")
        q.load_state(tmp_path / "ckpt.pt")
    finally:
        p.close()
        q.close()
    assert len(q.continue_data) == 3
    assert all(torch.is_tensor(row) and row.shape == (40, 30)
               for row in q.continue_data.data["cp_norm"])
    assert q.continue_data.data["segment_data"] == [False] * 3
    state = CK.load(tmp_path / "ckpt.pt")
    assert state["use_speech_classifier"] is False
    assert state["smiling"] is False


def test_file_loads_with_weights_only(tmp_path):
    p = Paule(seed=5, continue_data=_replay_frame(), **F64)
    try:
        p.save_state(tmp_path / "ckpt.pt")
    finally:
        p.close()
    state = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    assert state["format"] == CK.FORMAT
    assert {"pred_params", "pred_opt_state", "inv_params", "inv_opt_state",
            "embedder_params", "cp_gen_params", "mel_gen_params",
            "generator_state", "continue_data"} <= state.keys()


@pytest.mark.parametrize("kind", ["jax_checkpoint", "foreign_dict",
                                  "not_a_pickle"])
def test_foreign_file_raises(tmp_path, kind):
    path = tmp_path / "foreign"
    if kind == "jax_checkpoint":
        JPaule(seed=5).save_state(path)
    elif kind == "foreign_dict":
        torch.save({"weights": torch.zeros(3)}, path)
    else:
        path.write_bytes(pickle.dumps([1, 2]) + b"\x00garbage")
    p = Paule(seed=5, **F64)
    try:
        with pytest.raises(ValueError, match="not a paule_tpu_torch"):
            p.load_state(path)
    finally:
        p.close()


@pytest.mark.parametrize("variant,modules,trainers,keys", [
    ("use_speech_classifier", ("speech_classifier",), (),
     ("speech_classifier_params",)),
    ("use_somatosensory_feedback",
     ("cp_tube_model", "tube_mel_model", "tube_embedder"),
     ("tube_trainer", "tube_mel_trainer"),
     ("cp_tube_params", "cp_tube_opt_state", "tube_mel_params",
      "tube_mel_opt_state", "tube_embedder_params"))])
def test_variant_state_roundtrip(tmp_path, target, variant, modules,
                                 trainers, keys):
    """A variant's models, the tube models' Adam states (after
    ``continue_learning_tube``) and the dropout generator come back; an
    instance without the variant loads the file all the same."""
    p = Paule(seed=5, **{variant: True}, **F64)
    q = Paule(seed=999, pretrained_dir="random", **{variant: True}, **F64)
    plain = Paule(seed=6, **F64)
    try:
        p.plan_resynth(target_acoustic=target, objective="acoustic_semvec",
                       continue_learning=True, continue_learning_tube=True,
                       **TINY)
        torch.rand(3, generator=p.tube_generator)
        p.save_state(tmp_path / "ckpt.pt")
        q.load_state(tmp_path / "ckpt.pt")
        plain.load_state(tmp_path / "ckpt.pt")
        for attr in modules:
            assert _states_equal(getattr(p, attr).state_dict(),
                                 getattr(q, attr).state_dict()), attr
        for trainer in trainers:
            assert getattr(p, trainer).steps == 1
            assert _states_equal(
                getattr(p, trainer).optimizer.state_dict(),
                getattr(q, trainer).optimizer.state_dict()), trainer
        assert torch.equal(p.tube_generator.get_state(),
                           q.tube_generator.get_state())
        state = CK.load(tmp_path / "ckpt.pt")
        assert state[variant] is True
        assert set(keys) <= state.keys()
    finally:
        for x in (p, q, plain):
            x.close()


def test_state_taken_before_training_is_restored_bit_for_bit(target):
    """``paule_state`` of an instance on the CPU owns its tensors: a
    continue-learning plan after it (which updates the parameters and Adam
    moments in place) leaves it as it was, so restoring it brings back the
    instance as it was when the state was taken, and restoring it twice
    gives the same."""
    p = Paule(seed=5, continue_data=_replay_frame(), **F64)
    try:
        kw = dict(target_acoustic=target, continue_learning=True,
                  continue_learning_inv=True, **TINY)
        p.plan_resynth(**kw)  # the Adam moments are no longer empty
        before = [{k: v.clone() for k, v in m.state_dict().items()}
                  for m in (p.pred_model, p.inv_model)]
        opt_before = [CK._cpu(t.optimizer.state_dict())
                      for t in (p.pred_trainer, p.inv_trainer)]
        n_rows = len(p.continue_data)
        state = CK.paule_state(p)
        for _ in range(2):
            p.plan_resynth(**kw)
            assert not _states_equal(dict(p.pred_model.state_dict()),
                                     before[0]), "the plan did not train"
            CK.restore_paule_state(p, state)
            for m, want in zip((p.pred_model, p.inv_model), before):
                assert _states_equal(dict(m.state_dict()), want)
            for t, want in zip((p.pred_trainer, p.inv_trainer), opt_before):
                assert _states_equal(CK._cpu(t.optimizer.state_dict()), want)
            assert len(p.continue_data) == n_rows
    finally:
        p.close()
