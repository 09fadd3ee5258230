"""The slice as a whole: the port's ``Paule.plan_resynth`` against
``paule_tpu.api.Paule.plan_resynth`` with the same release weights on a
short synthesised target (float64 on the CPU on both sides), and the guards
of the port's boundaries."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch.api import Paule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def target():
    """~0.1 s of audio from a seeded smooth cp trajectory."""
    rng = np.random.default_rng(0)
    cp = np.clip(rng.normal(0, 0.05, (41, 30)).cumsum(0) * 0.2, -1, 1)
    return JS.speak(inv_normalize_cp(cp))


@pytest.mark.parametrize("objective,log_ii", [("acoustic_semvec", 1),
                                              ("acoustic", 2)])
def test_plan_resynth_matches_jax(target, objective, log_ii):
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective=objective, n_outer=1, n_inner=2, log_ii=log_ii,
              continue_learning=False, verbose=False)
    ref = JPaule(seed=7).plan_resynth(**kw)
    port = Paule(device="cpu", dtype=torch.float64, seed=7)
    try:
        out = port.plan_resynth(**kw)
    finally:
        port.close()

    np.testing.assert_allclose(out.planned_cp, ref.planned_cp, rtol=0,
                               atol=1e-6)
    for key in ("planned_loss_steps", "prod_loss_steps",
                "prod_semvec_loss_steps", "pred_semvec_loss_steps",
                "planned_mel_loss_steps"):
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=1e-5, atol=0, err_msg=key)
    for key in ("initial_cp", "target_mel", "prod_mel", "pred_mel",
                "initial_pred_semvec", "prod_semvec", "pred_semvec"):
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(out.initial_sig, ref.initial_sig)
    assert len(out.prod_mel_steps) == len(ref.prod_mel_steps) == 1


def test_options_outside_the_slice_raise(target):
    port = Paule(device="cpu", dtype=torch.float64)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.plan_resynth(target_acoustic=target, n_outer=1, n_inner=1,
                              continue_learning=True)
        for kw in ({"objective": "semvec"}, {"initialize_from": "semvec"},
                   {"past_cp": np.zeros((4, 30))}):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                port.plan_resynth(target_acoustic=target, n_outer=1,
                                  n_inner=1, continue_learning=False, **kw)
    finally:
        port.close()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Paule(device="cpu", use_speech_classifier=True)


def test_paule_without_cuda_raises(monkeypatch):
    """The default device is the card; without one, Paule() raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Paule()


def test_import_leaves_no_jax():
    """The port imports neither JAX nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import paule_tpu_torch\n"
        "for m in pkgutil.walk_packages(paule_tpu_torch.__path__, "
        "'paule_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'paule_tpu'))\n"
        "assert 'paule_tpu_torch.api' in sys.modules\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
