"""The plain reference against steps worked out by hand."""

import math

import numpy as np
import pytest
import torch

from portbench.plain import nets, plan, tables
from portbench.plain.dsp import Mel


def _sig(x):
    return 1.0 / (1.0 + math.exp(-x))


def test_one_lstm_step_by_hand():
    w_ih = [0.5, -0.3, 0.8, 0.1]
    w_hh = [0.2, 0.4, -0.6, 0.7]
    b = [0.05, -0.1, 0.0, 0.3]
    x, h, c = 0.5, 0.2, 0.3
    g = [x * w_ih[k] + h * w_hh[k] + b[k] for k in range(4)]
    c_new = _sig(g[1]) * c + _sig(g[0]) * math.tanh(g[2])
    h_new = _sig(g[3]) * math.tanh(c_new)
    t = lambda v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
    hh, cc = nets.lstm_step(t([x]), t([h]), t([c]), t(w_ih), t(w_hh),
                            torch.tensor(b, dtype=torch.float64))
    assert float(hh) == pytest.approx(h_new, rel=1e-14)
    assert float(cc) == pytest.approx(c_new, rel=1e-14)


def test_the_loop_is_the_steps_in_turn():
    gen = torch.Generator().manual_seed(3)
    r = lambda *s: torch.rand(*s, generator=gen, dtype=torch.float64)  # noqa
    x, w_ih, w_hh, b = r(2, 4, 3), r(3, 8), r(2, 8), r(8)
    out = nets.lstm(x, w_ih, w_hh, b)
    h = c = torch.zeros(2, 2, dtype=torch.float64)
    for t in range(4):
        h, c = nets.lstm_step(x[:, t], h, c, w_ih, w_hh, b)
        assert torch.allclose(out[:, t], h, rtol=1e-14, atol=0)


def test_the_stencil_is_exact_on_a_cubic():
    t = torch.arange(10, dtype=torch.float64)
    x = (t ** 3)[None, :, None]
    assert torch.allclose(plan.stencil(x)[0, :, 0], 3 * t[2:-2] ** 2)


def test_adams_first_step_moves_each_element_by_the_rate():
    x = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float64)
    g = torch.tensor([0.3, -2.0, 1e-3], dtype=torch.float64)
    new, m, v = plan.adam(x, g, torch.zeros(3, dtype=torch.float64),
                          torch.zeros(3, dtype=torch.float64), 1, 0.01)
    expect = 1.0 - 0.01 * g / (g.abs() + plan.EPS)
    assert torch.allclose(new, expect, rtol=1e-15)
    assert torch.allclose(v, 0.001 * g * g)


def test_silence_is_the_mels_zero():
    mel = Mel("cpu", torch.float64)(np.zeros((1, 2200)))
    assert mel.shape == (1, 11, 60)
    assert float(mel.abs().max()) == pytest.approx(0.0, abs=1e-12)


def test_a_tone_lands_in_its_mel_band():
    t = np.arange(4410) / 44100.0
    mel = Mel("cpu", torch.float64)(np.sin(2 * np.pi * 2000.0 * t)[None])
    band = int(mel[0, 5].argmax())
    hz = np.linspace(0, 22050, 513)
    centre = (Mel("cpu", torch.float64).fb[:, band].numpy() * hz).sum() / (
        Mel("cpu", torch.float64).fb[:, band].numpy().sum())
    assert abs(centre - 2000.0) < 250.0


def test_cp_denormalisation_spans_the_ranges():
    lo = tables.inv_normalize_cp(-np.ones(30))
    hi = tables.inv_normalize_cp(np.ones(30))
    assert np.allclose(lo, tables.CP_RANGES[:, 0])
    assert np.allclose(hi, tables.CP_RANGES[:, 1])


def test_doubling_then_halving_gives_back_the_steps():
    x = torch.rand(1, 5, 3, dtype=torch.float64)
    d = nets.double_sequence(x)
    assert torch.equal(d[:, ::2], x)
    assert torch.allclose(d[:, 1:-1:2], (x[:, :-1] + x[:, 1:]) / 2)
