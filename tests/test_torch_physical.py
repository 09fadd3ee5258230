"""Planning through the physical forward model,
``Paule(physical_forward=True)``, against ``paule_tpu.api.Paule(
physical_forward=True)`` in float64 on the CPU: a short ``plan_resynth``
with continue-learning of the inverse model (``initial_cp``, the plan, the
loss series, ``inv_model_loss`` and the produced and predicted arrays, to
``tests/torch_parity.py``'s tolerances: cp 1e-6 absolute, losses 1e-5
relative), the same under ``smiling=True`` (which pins cp onto the clip
bounds of the spectral model) with the planning gradients logged and held
to 1e-6 of their largest element, and a ``save_state``/``load_state``
round trip whose next plan is the same bit for bit."""

import numpy as np
import pytest
import torch

from paule_tpu_torch import synth
from paule_tpu_torch.api import Paule
from paule_tpu_torch.ops.normalize import inv_normalize_cp
from paule_tpu_torch.spectral import SpectralForwardModel
from torch_parity import compare, plan_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GRAD_RTOL = 1e-6
PHYSICAL = {"physical_forward": True}


def _target(n_frames=16, seed=4):
    rng = np.random.default_rng(seed)
    cp = np.clip(rng.normal(0, 0.1, (n_frames, 30)).cumsum(0) * 0.1, -1, 1)
    return synth.speak(inv_normalize_cp(cp))


KW = dict(objective="acoustic_semvec", initialize_from="acoustic",
          n_outer=2, n_inner=3, log_ii=1, n_batches=1, batch_size=2,
          n_epochs=1, continue_learning=True, continue_learning_inv=True,
          verbose=False)


def test_physical_plan_with_continue_learning_matches_jax():
    out, ref, port, _ = plan_both(dict(KW, target_acoustic=_target()),
                                  jax_init=PHYSICAL, port_init=PHYSICAL)
    compare(out, ref)
    assert isinstance(port.pred_model, SpectralForwardModel)
    # the physical model trains nothing; the inverse model trains
    assert out.pred_model_loss == [] == ref.pred_model_loss
    assert len(out.inv_model_loss) == 2
    assert port.pred_trainer.optimizer is None
    assert port.pred_trainer.steps == 0


def test_physical_plan_smiling_matches_jax_with_gradients():
    """``smiling=True`` pins LP and HY onto the tract bounds after every
    step, so the spectral model's clips tie; the logged planning
    gradients agree as well."""
    kw = dict(KW, target_acoustic=_target(seed=5), objective="acoustic",
              n_outer=1, n_inner=4, continue_learning=False,
              log_gradients=True)
    init = dict(PHYSICAL, smiling=True)
    out, ref, _port, _ = plan_both(kw, jax_init=init, port_init=init)
    compare(out, ref)
    info = synth.get_param_info("tract")
    tract = inv_normalize_cp(out.planned_cp)[:, :19]
    assert np.allclose(tract[:, 4], info["mins"][4])   # LP
    assert np.allclose(tract[:, 1], info["maxs"][1])   # HY
    grads, ref_grads = np.asarray(out.grad_steps), np.asarray(ref.grad_steps)
    assert grads.shape == ref_grads.shape and len(grads) == 4
    np.testing.assert_allclose(grads, ref_grads, rtol=0,
                               atol=GRAD_RTOL * np.abs(ref_grads).max())


def test_physical_forward_ignores_predictive_weights():
    """An injected predictive tree is ignored (as in the JAX package); the
    other models load as always."""
    p = Paule(device="cpu", dtype=torch.float64, seed=3,
              pretrained_dir="random", physical_forward=True,
              pred_model={"lstm": [], "post_linear": None})
    try:
        assert isinstance(p.pred_model, SpectralForwardModel)
        assert p.physical_forward
        assert sum(x.numel() for x in p.inv_model.parameters()) > 0
    finally:
        p.close()


def test_save_load_round_trip_gives_the_same_next_plan(tmp_path):
    kw = dict(KW, target_acoustic=_target(seed=6), n_outer=1)

    def paule():
        return Paule(device="cpu", dtype=torch.float64, seed=9,
                     physical_forward=True)

    first = paule()
    try:
        first.plan_resynth(**kw)
        first.save_state(tmp_path / "state.pt")
        again = first.plan_resynth(seed=11, **kw)
    finally:
        first.close()
    second = paule().load_state(tmp_path / "state.pt")
    try:
        assert second.pred_trainer.optimizer is None
        out = second.plan_resynth(seed=11, **kw)
    finally:
        second.close()
    np.testing.assert_array_equal(out.planned_cp, again.planned_cp)
    assert out.planned_loss_steps == again.planned_loss_steps
    assert out.inv_model_loss == again.inv_model_loss


@pytest.mark.parametrize("objective", ["acoustic", "semvec"])
def test_physical_batched_planning_runs(objective):
    """``parallel.batched`` drives the physical model too: its trainer
    without parameters reports the loss of each step and changes
    nothing."""
    from paule_tpu_torch.parallel.batched import plan_batch_resynth
    from paule_tpu_torch.dsp.targets import audio_target_to_mel

    p = Paule(device="cpu", dtype=torch.float64, seed=2,
              physical_forward=True)
    try:
        mels = np.stack([audio_target_to_mel(
            _target(seed=s), device="cpu", dtype=torch.float64)[2]
            for s in (7, 8)])
        out = plan_batch_resynth(p, mels, n_outer=1, n_inner=2,
                                 objective=objective, continue_learning=True,
                                 batch_size=2, n_epochs=1)
    finally:
        p.close()
    assert out["planned_cp"].shape == (2, 16, 30)
    assert len(out["pred_model_loss"]) == 1
    assert np.isfinite(out["pred_model_loss"]).all()
