"""The port's ceiling probes (``paule_tpu_torch.tools.kernel_ceiling_probes``)
on the CPU, where both forms take B1's and B2's plain versions: against
the Pallas kernels B1/B2 of ``paule_tpu.ops.pallas_lstm`` run in interpret
mode at a small H, in float32 (2e-5 absolute forward, 1e-4 relative
gradients, as ``tests/test_torch_lstm.py``), at batch 1, 3 and 8 (the
batch the card times beside B=1); the entry point on the CPU, at the TPU
probe's shape and at (402, 8); and an import that does nothing."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paule_tpu.ops import pallas_lstm as PL
from paule_tpu_torch.ops import lstm_kernels as K
from paule_tpu_torch.tools import kernel_ceiling_probes as P
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(PL, "INTERPRET", True)
    monkeypatch.setattr(PL, "_vmem_plan",
                        lambda seq, batch, hidden, words: (min(4, seq), None))


def _f32(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("variant", P.VARIANTS)
@pytest.mark.parametrize("batch,seq", [(1, 6), (3, 9), (8, 5)])
def test_probes_match_pallas(interpret, variant, batch, seq):
    rng = np.random.default_rng(batch)
    hidden = 8
    gx = _f32(rng, (seq, batch, 4 * hidden), 0.5)
    w = _f32(rng, (hidden, 4 * hidden), hidden ** -0.5)
    h0 = _f32(rng, (batch, hidden), 0.2)
    c0 = _f32(rng, (batch, hidden), 0.2)
    ghs = _f32(rng, (seq, batch, hidden))

    hs_j, cs_j = PL._lstm_core_fwd_impl(gx, w, h0, c0)
    dg_j, _dw, dh0_j, dc0_j = PL._lstm_core_bwd(
        (gx, w, h0, c0, hs_j, cs_j), (jnp.asarray(ghs), None))

    t = [torch.tensor(a) for a in (gx, w, h0, c0)]
    hs, cs = P.run_fwd(variant, *t)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), rtol=0,
                               atol=2e-5)
    hs_prev = torch.cat([t[2][None], hs[:-1]])
    cs_prev = torch.cat([t[3][None], cs[:-1]])
    acts = K.activate(t[0] + hs_prev @ t[1], hidden)
    dg, dh0, dc0 = P.run_bwd(variant, acts, cs_prev, torch.tensor(ghs), t[1])
    for a, b in ((dg, dg_j), (dh0, dh0_j), (dc0, dc0_j)):
        assert _rel(a.numpy(), b) <= 1e-4
    assert all(k.launches == 0 for k in P.KERNELS)


def test_variant_and_device_checks():
    z = torch.zeros(2, 1, 8)
    with pytest.raises(ValueError, match="variant"):
        P.run_fwd("diagonal", z, torch.zeros(2, 8), torch.zeros(1, 2),
                  torch.zeros(1, 2))
    with pytest.raises(ValueError, match="variant"):
        P.run_bwd("diagonal", z, torch.zeros(2, 1, 2), torch.zeros(2, 1, 2),
                  torch.zeros(2, 8))
    # a tensor off the CPU goes to the kernel, whose checks refuse float64
    # before anything is built or launched
    meta = dict(device="meta", dtype=torch.float64)
    for variant in P.VARIANTS:
        with pytest.raises(TypeError, match="float32"):
            P.run_fwd(variant, torch.empty(2, 1, 8, **meta),
                      torch.empty(2, 8, **meta), torch.empty(1, 2, **meta),
                      torch.empty(1, 2, **meta))
        with pytest.raises(TypeError, match="float32"):
            P.run_bwd(variant, torch.empty(2, 1, 8, **meta),
                      torch.empty(2, 1, 2, **meta),
                      torch.empty(2, 1, 2, **meta),
                      torch.empty(2, 8, **meta))
    assert all(k.launches == 0 for k in P.KERNELS)


@pytest.mark.parametrize("argv,shape", [
    ([], "T=1024 B=1 H=720"),
    (["--seq", "402", "--batch", "8"], "T=402 B=8 H=720")])
def test_entry_point_on_the_cpu(capsys, argv, shape):
    """The entry point at the TPU probe's shape and at continue-learning's
    (~3 s each on one CPU thread)."""
    assert P.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert shape in out and "not measured" in out


def test_import_does_nothing():
    """Importing the probe module builds, loads and launches nothing."""
    code = ("import paule_tpu_torch.tools.kernel_ceiling_probes as P\n"
            "assert P.LIBRARY._lib is None\n"
            "assert all(k.launches == 0 for k in P.KERNELS)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout == ""
