"""The port's speaker import (``paule_tpu_torch/synth/speaker_import.py``),
formant estimation (``dsp/formants.py``) and VocalTractLab plant
(``synth/vtl_plant.py``) against the JAX package's on the CPU.  No VTL
speaker ships with the repo, so the tests write a small synthetic VTL XML
speaker whose tables are the default speaker's.  The parse and the INI
text are identical (byte for byte); the fits are held to 1e-12 relative
(the same numpy code on the same samples); the formants to 1e-9 Hz."""

import numpy as np
import pytest

from paule_tpu.dsp import formants as JF
from paule_tpu.synth import speaker_import as JI
from paule_tpu_torch import synth
from paule_tpu_torch.dsp import formants as TF
from paule_tpu_torch.synth import speaker_import as TI
from paule_tpu_torch.synth import vtl_plant
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-12


def _params_xml(tag, info):
    return "".join(
        f'<{tag} index="{i}" name="{n}" min="{float(lo)!r}" '
        f'max="{float(hi)!r}" neutral="{float(ne)!r}"/>'
        for i, (n, lo, hi, ne) in enumerate(zip(
            info["names"], info["mins"], info["maxs"], info["neutrals"])))


def write_vtl_speaker(path, n_shapes=4, seed=0):
    """A VTL XML speaker with the default speaker's parameter tables,
    anatomy elements for the length estimate, ``n_shapes`` random tract
    shapes (one named with a space) and a selected glottis model with a
    ``modal`` and a ``voiceless-fricative`` shape."""
    tract = synth.get_param_info("tract")
    glottis = synth.get_param_info("glottis")
    rng = np.random.default_rng(seed)
    names = ["a", "i", "tt-alveolar-closure", "ll lateral"][:n_shapes]
    shapes = "".join(
        f'<shape name="{name}">' + "".join(
            f'<param name="{p}" value="{float(v)!r}"/>' for p, v in zip(
                tract["names"], rng.uniform(tract["mins"], tract["maxs"])))
        + "</shape>" for name in names)
    gshape = "".join(f'<control_param name="{p}" value="{float(v)!r}"/>'
                     for p, v in zip(glottis["names"], glottis["neutrals"]))
    xml = (
        "<speaker><vocal_tract_model><anatomy>"
        '<palate><p0 x="0.5" y="1.0"/><p1 x="3.25" y="1.4"/></palate>'
        '<pharynx fulcrum_x="-1.5" fulcrum_y="2.0"/>'
        '<larynx><narrow points="0.0 -1.0 0.5 -2.25 1.0 -1.5"/></larynx>'
        '<nasal_cavity length="11.4"/>'
        + _params_xml("param", tract)
        + "</anatomy><shapes>" + shapes + "</shapes></vocal_tract_model>"
        "<glottis_models>"
        '<glottis_model type="Triangular glottis" selected="0">'
        "<control_params/><static_params/></glottis_model>"
        '<glottis_model type="Geometric glottis" selected="1">'
        '<static_params><param index="0" name="RL" min="0.5" max="2.0" '
        'neutral="1.6"/></static_params>'
        "<control_params>" + _params_xml("param", glottis)
        + "</control_params><shapes>"
        '<shape name="modal">' + gshape + "</shape>"
        '<shape name="voiceless-fricative"><control_param name="'
        + glottis["names"][1] + '" value="0.0"/></shape>'
        "</shapes></glottis_model></glottis_models></speaker>")
    path.write_text(xml)
    return str(path)


@pytest.fixture
def speaker(tmp_path):
    synth.initialize()
    return write_vtl_speaker(tmp_path / "vtl.speaker")


def test_parse_matches_jax(speaker):
    parsed = TI.parse_vtl_speaker(speaker)
    assert parsed == JI.parse_vtl_speaker(speaker)
    assert parsed["glottis_model"] == "Geometric glottis"
    assert len(parsed["tract_params"]) == 19
    assert len(parsed["tract_shapes"]) == 4
    est = TI.estimate_base_length_cm(parsed)
    hy = synth.get_param_info("tract")["neutrals"][1]
    # (3.25 - -1.5) + (2.0 - (hy - 2.25)), to 2 decimals
    assert est == JI.estimate_base_length_cm(parsed) == round(
        4.75 + 2.0 - (hy - 2.25), 2)
    # without the anatomy elements there is no estimate
    parsed["anatomy"].pop("larynx_depth")
    assert TI.estimate_base_length_cm(parsed) is None


@pytest.mark.parametrize("kw", [
    {}, {"name": "syn", "base_length_cm": 16.5},
    {"voiceless": ["tt-alveolar-closure"]},
])
def test_to_ini_and_import_are_byte_identical(speaker, tmp_path, kw):
    parsed = TI.parse_vtl_speaker(speaker)
    text = TI.to_ini(parsed, **kw)
    assert text == JI.to_ini(JI.parse_vtl_speaker(speaker), **kw)
    assert "ll_lateral 1" in text
    TI.import_speaker(speaker, tmp_path / "port.ini", **kw)
    JI.import_speaker(speaker, tmp_path / "jax.ini", **kw)
    assert ((tmp_path / "port.ini").read_bytes()
            == (tmp_path / "jax.ini").read_bytes())


def test_imported_speaker_loads_and_speaks(speaker, tmp_path):
    out = TI.import_speaker(speaker, tmp_path / "syn.ini", name="syn")
    synth.initialize(str(out))
    try:
        info = synth.get_param_info("tract")
        parsed = TI.parse_vtl_speaker(speaker)
        np.testing.assert_allclose(info["mins"],
                                   [r[2] for r in parsed["tract_params"]])
        neutral = np.concatenate([info["neutrals"], synth.get_param_info(
            "glottis")["neutrals"]])
        sig, sr = synth.speak(np.tile(neutral, (41, 1)))
        assert sr == 44100 and np.isfinite(sig).all()
    finally:
        synth.initialize()


def _tube_fn(q):
    """A synthetic tract model for the fit: smooth in the 19 values."""
    x = (np.arange(40) + 0.5) / 40
    area = np.exp(0.3 * np.sin(3 * x * (1 + q[:5].sum())) + 0.1 * q[8])
    return {"tube_length_cm": np.full(40, 0.4 + 0.01 * q[0]),
            "tube_area_cm2": area, "incisor_pos_cm": 15.0 + q[3],
            "tongue_tip_side_elevation": 0.1 * q[11],
            "velum_opening_cm2": max(q[7], 0.0)}


@pytest.mark.parametrize("quadratic", [True, False])
def test_fit_tract_affine_matches_jax(speaker, tmp_path, quadratic):
    parsed = TI.parse_vtl_speaker(speaker)
    kw = dict(n_samples=120, seed=3, quadratic=quadratic,
              emphasize_shapes=("a",), emphasize_weight=2)
    fit = TI.fit_tract_affine(parsed, _tube_fn, **kw)
    ref = JI.fit_tract_affine(JI.parse_vtl_speaker(speaker), _tube_fn, **kw)
    for key in ("area", "length", "incisor", "tongue_tip", "velum"):
        np.testing.assert_allclose(fit[key], ref[key], rtol=RTOL, atol=1e-12)
    assert fit["diagnostics"] == pytest.approx(ref["diagnostics"],
                                               rel=RTOL)
    assert fit["area"].shape == (40, 39 if quadratic else 20)
    lines = TI.tract_affine_ini_lines(fit)
    assert lines == JI.tract_affine_ini_lines(ref)
    TI.import_speaker(speaker, tmp_path / "p.ini", tube_fit=fit,
                      source={"deriv_mix": 1.5, "skew_offset": 0.0})
    JI.import_speaker(speaker, tmp_path / "j.ini", tube_fit=ref,
                      source={"deriv_mix": 1.5, "skew_offset": 0.0})
    assert ((tmp_path / "p.ini").read_bytes()
            == (tmp_path / "j.ini").read_bytes())


def test_fit_source_on_a_synthetic_objective():
    """A measure function whose formants move with the source settings;
    both fits take the same path to the same optimum."""
    vtl = {"a": (700.0, 1200.0), "i": (300.0, 2200.0)}

    def measure(src):
        d, s = src["deriv_mix"], src["skew_offset"]
        return {"a": (650.0 + 30 * d - 20 * s, 1150.0 + 10 * s),
                "i": (260.0 + 25 * d + 5 * s, 2150.0 + 20 * d)}

    fit = TI.fit_source(measure, vtl)
    ref = JI.fit_source(measure, vtl)
    assert fit == ref
    assert fit["diagnostics"]["n_evaluations"] > 15
    assert TI.source_ini_lines(fit) == JI.source_ini_lines(ref)
    assert TI.source_ini_lines({"deriv_mix": 0.0}) == []


def test_lpc_formants_of_a_synthesized_vowel():
    synth.initialize()
    info = synth.get_param_info("tract")
    neutral = np.concatenate([info["neutrals"], synth.get_param_info(
        "glottis")["neutrals"]])
    sig, sr = synth.speak(np.tile(neutral, (161, 1)))
    out = TF.lpc_formants(sig, sr)
    np.testing.assert_allclose(out, JF.lpc_formants(sig, sr), rtol=0,
                               atol=1e-9)
    assert len(out) == 3 and 120 < out[0] < out[1]
    with pytest.raises(ValueError, match="too short"):
        TF.lpc_formants(sig[:1000], sr)
    with pytest.raises(ValueError, match="1-D"):
        TF.lpc_formants(sig[None], sr)


@pytest.mark.parametrize("xml,needle", [
    ("<speaker><glottis_models/></speaker>", "vocal_tract_model"),
    ("<speaker><vocal_tract_model></vocal_tract_model>"
     "<glottis_models><glottis_model type='g'><control_params/>"
     "<static_params/></glottis_model></glottis_models></speaker>",
     "anatomy"),
    ("<speaker><vocal_tract_model><anatomy/></vocal_tract_model>"
     "<glottis_models></glottis_models></speaker>", "glottis_models"),
    ("<speaker><vocal_tract_model><anatomy/></vocal_tract_model>"
     "<glottis_models><glottis_model type='Geometric glottis'>"
     "<static_params/></glottis_model></glottis_models></speaker>",
     "control_params"),
])
def test_malformed_xml_reports_missing_element(xml, needle, tmp_path):
    f = tmp_path / "bad.speaker"
    f.write_text(xml)
    with pytest.raises(ValueError, match=needle) as port:
        TI.parse_vtl_speaker(f)
    with pytest.raises(ValueError) as ref:
        JI.parse_vtl_speaker(f)
    assert str(port.value) == str(ref.value)


def test_vtl_plant_is_unavailable_without_the_library(tmp_path,
                                                      monkeypatch):
    """The repo ships no VocalTractLab library."""
    assert not vtl_plant.vtl_available(str(tmp_path / "lib.so"),
                                       str(tmp_path / "x.speaker"))
    lib, spk = tmp_path / "lib.so", tmp_path / "x.speaker"
    lib.write_bytes(b"")
    spk.write_text("")
    assert vtl_plant.vtl_available(str(lib), str(spk))
    monkeypatch.setenv("PAULE_TPU_HIDE_REFERENCE", "1")
    assert not vtl_plant.vtl_available(str(lib), str(spk))
    with pytest.raises(ValueError, match=r"\(19,\)"):
        vtl_plant.VTLPlant.__new__(vtl_plant.VTLPlant).tract_to_tube(
            np.zeros(18))
