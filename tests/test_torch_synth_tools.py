"""The rest of the port's synthesizer binding against ``paule_tpu.synth`` on
the CPU: constants, parameter ranges, single-frame tube extraction and
transfer functions, synthesis from tube areas, the tract clamps, speaker
files, segment files and gestural scores, EMA and SVG export, and
``read_cp`` with its error cases.  Both packages build the same C++ sources
with the same flags, so every number is held bit for bit (tolerance 0)."""

import os

import numpy as np
import pytest

from paule_tpu import synth as J
from paule_tpu_torch import synth as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEG = ("name = a; duration_s = 0.10;\n"
       "name = t; duration_s = 0.05;\n"
       "name = a; duration_s = 0.10;\n")


@pytest.fixture(autouse=True)
def _default_speaker():
    J.initialize()
    T.initialize()
    yield


def _tracts(n, seed=0):
    info = T.get_param_info("tract")
    rng = np.random.default_rng(seed)
    return rng.uniform(info["mins"] - 0.3, info["maxs"] + 0.3, (n, 19))


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_version_constants_and_param_info():
    assert T.version() == J.version()
    assert T.get_constants() == J.get_constants()
    for which in ("tract", "glottis"):
        _same(T.get_param_info(which), J.get_param_info(which))
    assert len(T.get_param_info("tract")["names"]) == 19
    assert len(T.get_param_info("glottis")["names"]) == 11


@pytest.mark.parametrize("fn,args", [
    ("tract_to_tube", ()),
    ("get_transfer_function", (257,)),
    ("input_tract_to_limited_tract", ()),
    ("calc_tongue_root_automatically", ()),
])
def test_single_frame_functions_are_bit_identical(fn, args):
    """Tract rows inside and 0.3 beyond the speaker's ranges."""
    for tract in _tracts(6):
        _same(getattr(T, fn)(tract, *args), getattr(J, fn)(tract, *args))


def test_tract_to_tube_layout():
    tl, ta, ai, inc, tt, vel = T.tract_to_tube(_tracts(1)[0])
    assert tl.shape == ta.shape == ai.shape == (40,)
    assert ai.dtype == np.int32
    assert all(isinstance(v, float) for v in (inc, tt, vel))


def test_calc_tongue_root_leaves_its_input():
    tract = _tracts(1)[0]
    before = tract.copy()
    T.calc_tongue_root_automatically(tract)
    np.testing.assert_array_equal(tract, before)


@pytest.mark.parametrize("fn,arg", [
    ("tract_to_tube", "tract_params"),
    ("get_transfer_function", "tract_params"),
])
def test_non_finite_tract_raises(fn, arg):
    tract = _tracts(1)[0]
    tract[3] = np.nan
    for mod in (J, T):
        with pytest.raises(ValueError, match=arg):
            getattr(mod, fn)(tract)


def test_synthesis_add_tube_is_bit_identical():
    """From the same state (a block synthesis resets it), three tube states
    with and without section lengths and a velum opening."""
    glottis = T.get_param_info("glottis")["neutrals"]
    cps = np.tile(np.concatenate([T.get_param_info("tract")["neutrals"],
                                  glottis]), (3, 1))
    J.speak(cps)
    T.speak(cps)
    rng = np.random.default_rng(1)
    for k in range(4):
        areas = rng.uniform(0.2, 4.0, 40)
        kw = ({"tube_lengths": rng.uniform(0.3, 0.5, 40),
               "velum_opening_cm2": 0.4} if k % 2 else {})
        n = 0 if k == 0 else 110
        out = T.synthesis_add_tube(n, areas, glottis, **kw)
        np.testing.assert_array_equal(
            out, J.synthesis_add_tube(n, areas, glottis, **kw))
        assert out.shape == (n,)


@pytest.mark.parametrize("bad,match", [
    ({"tube_areas": np.ones(39)}, r"\(40,\)"),
    ({"tube_areas": np.full(40, np.nan)}, "tube_areas"),
    ({"glottis": np.full(11, np.inf)}, "glottis"),
])
def test_synthesis_add_tube_errors(bad, match):
    kw = {"tube_areas": np.ones(40),
          "glottis": T.get_param_info("glottis")["neutrals"]}
    kw.update(bad)
    for mod in (J, T):
        with pytest.raises(ValueError, match=match):
            mod.synthesis_add_tube(110, kw["tube_areas"], kw["glottis"])


def test_save_speaker_writes_the_same_file(tmp_path):
    J.save_speaker(tmp_path / "jax.speaker")
    T.save_speaker(tmp_path / "port.speaker")
    assert ((tmp_path / "port.speaker").read_bytes()
            == (tmp_path / "jax.speaker").read_bytes())
    # and it loads back
    T.initialize(str(tmp_path / "port.speaker"))
    _same(T.get_param_info("tract"), J.get_param_info("tract"))


def test_seg_to_cps_and_ges_round_trip(tmp_path):
    """A segment file -> cps; its gestural score -> cps, audio (also as a
    WAV), EMA and mesh files; all as the JAX package gives them."""
    seg = tmp_path / "word.seg"
    seg.write_text(SEG)
    cps = T.seg_to_cps(str(seg))
    np.testing.assert_array_equal(cps, J.seg_to_cps(str(seg)))
    assert cps.shape[1] == 30 and cps.shape[0] >= 100
    ges = str(tmp_path / "word.ges")
    assert T._default().pts_segment_sequence_to_gestural_score(
        str(seg).encode(), ges.encode()) == 0
    np.testing.assert_array_equal(T.ges_to_cps(ges), J.ges_to_cps(ges))
    audio, sr = T.ges_to_audio(ges, str(tmp_path / "port.wav"))
    ref, ref_sr = J.ges_to_audio(ges, str(tmp_path / "jax.wav"))
    assert sr == ref_sr == 44100
    np.testing.assert_array_equal(audio, ref)
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "jax.wav").read_bytes())
    T.ges_to_ema_and_mesh(ges, "port", path=str(tmp_path / "p"))
    J.ges_to_ema_and_mesh(ges, "port", path=str(tmp_path / "j"))
    files = sorted(os.listdir(tmp_path / "p"))
    assert files and files == sorted(os.listdir(tmp_path / "j"))
    for name in files:
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())


@pytest.mark.parametrize("fn", ["seg_to_cps", "ges_to_cps", "ges_to_audio"])
def test_missing_input_file_raises(fn, tmp_path):
    """The native call fails, and both packages raise ``ValueError``."""
    missing = str(tmp_path / "missing.txt")
    for mod in (J, T):
        with pytest.raises(ValueError, match="Errorcode"):
            getattr(mod, fn)(missing)


def test_export_svgs_and_ema(tmp_path):
    seg = tmp_path / "word.seg"
    seg.write_text(SEG)
    cps = T.seg_to_cps(str(seg))
    T.export_svgs(cps, path=str(tmp_path / "p"), hop_length=40)
    J.export_svgs(cps, path=str(tmp_path / "j"), hop_length=40)
    files = sorted(os.listdir(tmp_path / "p"))
    assert files == [f"tract{i:05d}.svg" for i in range(cps.shape[0] // 40)]
    for name in files:
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
    emas = T.cps_to_ema(cps[:12])
    assert emas.equals(J.cps_to_ema(cps[:12]))
    assert len(emas) == 12 and "time" in emas.columns
    T.cps_to_ema_and_mesh(cps[:5], "mesh", path=str(tmp_path / "m"))
    assert any(f.startswith("mesh-") for f in os.listdir(tmp_path / "m"))
    with pytest.raises(ValueError, match=r"\(seq, 30\)"):
        T.cps_to_ema_and_mesh(cps[None, :5], "mesh", path=str(tmp_path))


def _write_cp_file(path, cps, glottis_model="Geometric glottis",
                   n_states=None, drop=None):
    lines = ["#"] * 6 + [glottis_model, str(n_states or len(cps))]
    for row in cps:
        lines.append(" ".join(f"{v:.17g}" for v in row[19:]))
        lines.append(" ".join(f"{v:.17g}" for v in row[:19]))
    if drop is not None:
        lines[drop] = " ".join(lines[drop].split()[:-1])
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_read_cp_matches_and_round_trips(tmp_path):
    rng = np.random.default_rng(2)
    cps = rng.normal(size=(7, 30)) * 3
    path = _write_cp_file(tmp_path / "seq.txt", cps)
    np.testing.assert_array_equal(T.read_cp(path), J.read_cp(path))
    np.testing.assert_array_equal(T.read_cp(path), cps)


@pytest.mark.parametrize("case", ["glottis_model", "more_states",
                                  "glottis_columns", "tract_columns"])
def test_read_cp_rejects_malformed_files(case, tmp_path):
    """Both packages raise ``ValueError``: another glottis model, more
    states than the header claims, a glottis or tract line one value
    short."""
    cps = np.zeros((3, 30))
    kw = {"glottis_model": {"glottis_model": "Triangular glottis"},
          "more_states": {"n_states": 2},
          "glottis_columns": {"drop": 8},
          "tract_columns": {"drop": 9}}[case]
    path = _write_cp_file(tmp_path / "bad.txt", cps, **kw)
    for mod in (J, T):
        with pytest.raises(ValueError):
            mod.read_cp(path)


def test_synth_pool_serves_concurrent_callers():
    """16 threads (more than the host's cores) speak one trajectory
    through one pool at once: each gets the audio of a fresh instance,
    bit for bit.  Without the pool's lock two threads synthesise on the
    same instance and the audio is corrupt (errors above its peak)."""
    import sys
    import threading

    from paule_tpu_torch.ops.normalize import inv_normalize_cp

    rng = np.random.default_rng(0)
    cp = inv_normalize_cp(np.clip(
        rng.normal(0, 0.05, (201, 30)).cumsum(0) * 0.2, -1, 1))
    fresh = T.SynthPool(size=1)
    try:
        ref = fresh.speak(cp)[0]
    finally:
        fresh.close()
    pool = T.SynthPool(size=4)
    outs, errors = [], []

    def worker():
        try:
            for _ in range(4):
                outs.append(pool.speak(cp)[0])
        except Exception as exc:  # noqa: BLE001  (reported below)
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        pool.close()
    assert not errors, errors
    assert len(outs) == 64
    for out in outs:
        assert np.array_equal(out, ref)
