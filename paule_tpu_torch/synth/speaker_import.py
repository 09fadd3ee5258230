"""Import a VocalTractLab XML speaker into the synthesizer's INI speaker
format (the port's own copy of ``paule_tpu/synth/speaker_import.py``; the
INI text is the same byte for byte).

A VocalTractLab (VTL) speaker is an XML file for the VTL library.  The
synthesizer here reads a much smaller INI format
(``paule_tpu/synth/speaker/default.speaker``, parsed by
``paule_tpu/synth/csrc/model.cpp`` ``Speaker::load``) whose anatomy is
three scalars plus per-parameter ranges and phone targets.  The import
reads the parts of a VTL speaker that map onto that model:

* the 19 vocal-tract control parameters (name / min / max / neutral), a
  copy of the XML ``<anatomy>`` ``<param>`` table;
* the 11 glottis control parameters of the *selected* glottis model, a
  copy of its ``<control_params>`` table;
* ``fold_length_cm`` from the glottis model's rest length (``RL``
  neutral), ``nasal_length_cm`` from ``<nasal_cavity length=>``;
* ``base_length_cm`` from a two-leg bent-tube estimate (below);
* every vocal-tract ``<shape>`` as a phone target: its 19 tract values
  plus glottis values from the glottis model's ``modal`` shape (else the
  control parameters' neutrals).

The spline geometry (palate and jaw contours, tongue radii, velum curves)
has no slot in the functional 19-parameter -> area model and is not
imported; :func:`fit_tract_affine` and :func:`fit_source` fit the
remaining anatomy against an external tract model and synthesizer.

Tract length estimate: the midline runs up the pharynx (vertical leg) and
bends at the velum to run along the palate to the lips (horizontal leg):

    horizontal = max palate x  - pharynx fulcrum x
    vertical   = pharynx fulcrum y - (hyoid-rest y - larynx depth)

with hyoid-rest y the neutral of the ``HY`` parameter and larynx depth the
vertical extent of the ``<larynx>`` ``narrow`` outline.

CLI: ``python -m paule_tpu_torch speaker-import JD3.speaker -o jd3.speaker``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

#: tau heuristic per shape class (matches the builtin phone table's
#: conventions, model.cpp builtin_default)
_TAU_BY_CLASS = {"closure": 0.010, "fricative": 0.012, "lateral": 0.014}
_TAU_VOWEL = 0.018


def parse_vtl_speaker(path):
    """Parse a VTL XML speaker file into a plain dict.

    Returns keys: ``tract_params`` / ``glottis_params`` (lists of
    ``(index, name, min, max, neutral)``), ``glottis_static`` (name ->
    neutral), ``glottis_shapes`` / ``tract_shapes`` (name -> {param:
    value}), ``anatomy`` (scalars used by the importer), ``glottis_model``
    (the selected model's type string).
    """
    root = ET.parse(str(path)).getroot()
    vt = root.find("vocal_tract_model")
    if vt is None:
        raise ValueError(f"{path}: not a VTL speaker file "
                         "(no <vocal_tract_model>)")
    anatomy = vt.find("anatomy")
    if anatomy is None:
        raise ValueError(f"{path}: <vocal_tract_model> has no <anatomy>")

    def param_rows(parent):
        rows = []
        for p in parent.findall("param"):
            rows.append((int(p.get("index")), p.get("name"),
                         float(p.get("min")), float(p.get("max")),
                         float(p.get("neutral"))))
        rows.sort()
        return rows

    tract_params = param_rows(anatomy)

    tract_shapes = {}
    shapes = vt.find("shapes")
    if shapes is not None:
        for sh in shapes.findall("shape"):
            tract_shapes[sh.get("name")] = {
                p.get("name"): float(p.get("value"))
                for p in sh.findall("param")}

    # the selected glottis model (selected="1"; first model otherwise)
    gms = root.find("glottis_models")
    if gms is None:
        raise ValueError(f"{path}: no <glottis_models>")
    models = gms.findall("glottis_model")
    if not models:
        raise ValueError(f"{path}: <glottis_models> is empty")
    selected = next((m for m in models if m.get("selected") == "1"),
                    models[0])
    control = selected.find("control_params")
    static = selected.find("static_params")
    if control is None or static is None:
        missing = ("control_params" if control is None else "static_params")
        raise ValueError(
            f"{path}: selected glottis model "
            f"'{selected.get('type', '?')}' has no <{missing}>")
    glottis_params = param_rows(control)
    glottis_static = {p.get("name"): float(p.get("neutral"))
                      for p in static.findall("param")}
    glottis_shapes = {}
    gshapes = selected.find("shapes")
    if gshapes is not None:
        for sh in gshapes.findall("shape"):
            glottis_shapes[sh.get("name")] = {
                p.get("name"): float(p.get("value"))
                for p in sh.findall("control_param")}

    # anatomy scalars for the tract-length estimate
    scal = {}
    nasal = anatomy.find("nasal_cavity")
    if nasal is not None:
        scal["nasal_length_cm"] = float(nasal.get("length"))
    palate = anatomy.find("palate")
    if palate is not None:
        xs = [float(p.get("x")) for p in palate if p.get("x") is not None]
        if xs:
            scal["palate_x_max"] = max(xs)
    pharynx = anatomy.find("pharynx")
    if pharynx is not None:
        scal["pharynx_fulcrum_x"] = float(pharynx.get("fulcrum_x"))
        scal["pharynx_fulcrum_y"] = float(pharynx.get("fulcrum_y"))
    larynx = anatomy.find("larynx")
    if larynx is not None:
        narrow = larynx.find("narrow")
        if narrow is not None and narrow.get("points"):
            vals = [float(v) for v in narrow.get("points").split()]
            ys = vals[1::2]
            if ys:
                scal["larynx_depth"] = -min(ys)

    return {
        "name": selected.get("type", "vtl-import"),
        "tract_params": tract_params,
        "glottis_params": glottis_params,
        "glottis_static": glottis_static,
        "glottis_shapes": glottis_shapes,
        "tract_shapes": tract_shapes,
        "anatomy": scal,
        "glottis_model": selected.get("type", ""),
    }


def estimate_base_length_cm(parsed):
    """Two-leg bent-tube tract-length estimate (see module docstring).

    Returns ``None`` when the XML lacks the needed anatomy elements.
    """
    a = parsed["anatomy"]
    hy = next((r for r in parsed["tract_params"] if r[1] == "HY"), None)
    need = ("palate_x_max", "pharynx_fulcrum_x", "pharynx_fulcrum_y",
            "larynx_depth")
    if hy is None or any(k not in a for k in need):
        return None
    horizontal = a["palate_x_max"] - a["pharynx_fulcrum_x"]
    vertical = a["pharynx_fulcrum_y"] - (hy[4] - a["larynx_depth"])
    return round(horizontal + vertical, 2)


def _phone_tau(name):
    for cls, tau in _TAU_BY_CLASS.items():
        if cls in name:
            return tau
    return _TAU_VOWEL


def to_ini(parsed, *, name=None, base_length_cm=None, voiceless=()):
    """Render a parsed VTL speaker as paule_tpu INI speaker text.

    ``voiceless`` names phones to emit with voiced=0 (VTL keeps voicing in
    gestural scores, not shapes, so the default is voiced=1 with the
    glottis model's ``modal`` shape; voiceless phones get the
    ``voiceless-fricative`` glottis shape when the model defines one).
    """
    tract = parsed["tract_params"]
    glottis = parsed["glottis_params"]
    if len(tract) != 19:
        raise ValueError(f"expected 19 tract params, got {len(tract)}")
    if len(glottis) != 11:
        raise ValueError(f"expected 11 glottis params, got {len(glottis)}")

    if base_length_cm is None:
        base_length_cm = estimate_base_length_cm(parsed)
    fold = parsed["glottis_static"].get("RL")
    nasal = parsed["anatomy"].get("nasal_length_cm")

    gnames = [r[1] for r in glottis]
    gneutral = {r[1]: r[4] for r in glottis}
    modal = dict(gneutral)
    modal.update(parsed["glottis_shapes"].get(
        "modal", parsed["glottis_shapes"].get("default", {})))
    unvoiced = dict(gneutral)
    unvoiced.update(parsed["glottis_shapes"].get(
        "voiceless-fricative", parsed["glottis_shapes"].get("open", {})))

    lines = ["# imported from a VocalTractLab XML speaker by "
             "paule_tpu.synth.speaker_import", "",
             "[meta]", f"name = {name or 'vtl-import'}", "", "[anatomy]"]
    if base_length_cm is not None:
        lines.append(f"base_length_cm = {base_length_cm}")
    if fold is not None:
        lines.append(f"fold_length_cm = {fold}")
    if nasal is not None:
        lines.append(f"nasal_length_cm = {nasal}")

    lines += ["", "[tract_params]"]
    for idx, pname, mn, mx, ne in tract:
        lines.append(f"{idx} {pname} {mn} {mx} {ne}")
    lines += ["", "[glottis_params]"]
    for idx, pname, mn, mx, ne in glottis:
        lines.append(f"{idx} {pname} {mn} {mx} {ne}")

    lines += ["", "[phones]"]
    voiceless = set(voiceless)
    for shname, shvals in parsed["tract_shapes"].items():
        # INI rows are whitespace-tokenized (model.cpp Speaker::load):
        # spaces inside a shape name would shift every following column
        safe = shname.replace(" ", "_")
        voiced = 0 if shname in voiceless else 1
        gsrc = unvoiced if shname in voiceless else modal
        tvals = [shvals.get(pname, ne)
                 for _, pname, _, _, ne in tract]
        gvals = [gsrc.get(g, gneutral[g]) for g in gnames]
        row = " ".join(f"{v:.6g}" for v in (tvals + gvals))
        lines.append(f"{safe} {voiced} {_phone_tau(shname)} {row}")
    return "\n".join(lines) + "\n"


def fit_tract_affine(parsed, tract_to_tube_fn, *, n_samples=1500, seed=0,
                     ridge=1e-4, quadratic=True, area_floor_cm2=1e-2,
                     shape_weight=6, emphasize_shapes=(),
                     emphasize_weight=0):
    """Fit a ``[tract_affine]`` tube map against an external tract model.

    ``tract_to_tube_fn(tract_row (19,)) -> dict`` must return the ground
    truth for one tract state: ``tube_length_cm (40,)``,
    ``tube_area_cm2 (40,)``, ``incisor_pos_cm``,
    ``tongue_tip_side_elevation``, ``velum_opening_cm2`` — e.g.
    :meth:`paule_tpu_torch.synth.vtl_plant.VTLPlant.tract_to_tube`, VTL's
    own ``vtlTractToTube``.

    The functional geometric model (make_geometry, model.cpp) spans a far
    smaller area dynamic range than VTL's 3-D anatomy (~0.3-4 cm² vs
    0.25-8 cm²), which compresses the imported speaker's formant
    space.  This fit replaces the geometric
    area map entirely: per-section log-area (resampled onto our uniform
    40-section grid) as a ridge-regressed affine(+squared) function of
    the 19 tract params, sampled over the speaker's shape inventory,
    convex shape combinations, jittered shapes, and uniform range draws.

    Returns a dict with ``area (40, n_coef)``, ``length``, ``incisor``,
    ``tongue_tip``, ``velum`` (each ``(n_coef,)``) in RAW-parameter
    feature space ``[1, q, q^2]``, plus fit diagnostics.
    """
    import numpy as np

    tract = parsed["tract_params"]
    lo = np.array([r[2] for r in tract])
    hi = np.array([r[3] for r in tract])
    mid = 0.5 * (lo + hi)
    half = np.maximum(0.5 * (hi - lo), 1e-9)

    shapes = np.array([
        np.clip([sh.get(pname, ne) for _, pname, _, _, ne in tract], lo, hi)
        for sh in parsed["tract_shapes"].values()])
    shape_names = list(parsed["tract_shapes"])
    rng = np.random.default_rng(seed)
    # the shape inventory is what plans/validations actually visit — weight
    # it above the space-filling samples by replication
    samples = [np.repeat(shapes, max(1, int(shape_weight)), axis=0)]
    if emphasize_shapes and emphasize_weight:
        # e.g. the cardinal vowels whose formants anchor a calibration:
        # extra replication pulls the regression's area residual toward
        # zero exactly where the acoustic validation measures it
        idx = [shape_names.index(n) for n in emphasize_shapes
               if n in shape_names]
        if idx:
            samples.append(np.repeat(shapes[idx],
                                     int(emphasize_weight), axis=0))
    n_extra = max(0, n_samples - len(samples[0]))
    n_mix = int(0.45 * n_extra)
    n_jit = int(0.35 * n_extra)
    n_uni = n_extra - n_mix - n_jit
    if len(shapes) >= 2 and n_mix:
        i1 = rng.integers(0, len(shapes), n_mix)
        i2 = rng.integers(0, len(shapes), n_mix)
        alpha = rng.uniform(0, 1, (n_mix, 1))
        samples.append(alpha * shapes[i1] + (1 - alpha) * shapes[i2])
    if len(shapes) and n_jit:
        ij = rng.integers(0, len(shapes), n_jit)
        jit = rng.normal(0, 0.08, (n_jit, 19)) * (hi - lo)
        samples.append(np.clip(shapes[ij] + jit, lo, hi))
    if n_uni:
        samples.append(rng.uniform(lo, hi, (n_uni, 19)))
    Q = np.concatenate(samples)

    uniform_mid = (np.arange(40) + 0.5) / 40.0
    y_logarea = np.empty((len(Q), 40))
    y_scalars = np.empty((len(Q), 4))  # length, incisor, tts, velum
    for n, q in enumerate(Q):
        gt = tract_to_tube_fn(q)
        lens = np.asarray(gt["tube_length_cm"], dtype=np.float64)
        area = np.asarray(gt["tube_area_cm2"], dtype=np.float64)
        total = float(lens.sum())
        pos = (np.cumsum(lens) - 0.5 * lens) / total
        la = np.log(np.maximum(area, area_floor_cm2))
        y_logarea[n] = np.interp(uniform_mid, pos, la)
        y_scalars[n] = (total, gt["incisor_pos_cm"],
                        gt["tongue_tip_side_elevation"],
                        gt["velum_opening_cm2"])

    # standardized features for conditioning; coefficients converted back
    # to raw-q space afterwards (model.cpp affine_eval uses raw params)
    Z = (Q - mid) / half
    feats = [np.ones((len(Q), 1)), Z]
    if quadratic:
        feats.append(Z * Z)
    X = np.concatenate(feats, axis=1)
    n_feat = X.shape[1]
    pen = ridge * len(Q) * np.eye(n_feat)
    pen[0, 0] = 0.0  # don't shrink the intercept
    gram = X.T @ X + pen
    Y = np.concatenate([y_logarea, y_scalars], axis=1)
    W_std = np.linalg.solve(gram, X.T @ Y)  # (n_feat, 44)

    # convert standardized-feature coefficients to raw q / q^2 features
    def to_raw(w):
        b = w[0]
        c = w[1:20] / half
        out = np.zeros(39 if quadratic else 20)
        if quadratic:
            d = w[20:39] / (half * half)
            b = b - np.dot(w[1:20], mid / half) \
                + np.dot(w[20:39], (mid / half) ** 2)
            c = c - 2.0 * d * mid
            out[20:] = d
        else:
            b = b - np.dot(w[1:20], mid / half)
        out[0] = b
        out[1:20] = c
        return out

    W_raw = np.stack([to_raw(W_std[:, k]) for k in range(Y.shape[1])])
    pred = X @ W_std
    resid = pred[:, :40] - y_logarea
    diag = {
        "n_samples": int(len(Q)),
        "n_shapes": int(len(shapes)),
        "quadratic": bool(quadratic),
        "logarea_rmse": float(np.sqrt(np.mean(resid ** 2))),
        "logarea_rmse_shapes": float(np.sqrt(np.mean(
            resid[:len(shapes) * max(1, int(shape_weight))] ** 2))),
        "length_rmse_cm": float(np.sqrt(np.mean(
            (pred[:, 40] - y_scalars[:, 0]) ** 2))),
    }
    return {
        "area": W_raw[:40],
        "length": W_raw[40],
        "incisor": W_raw[41],
        "tongue_tip": W_raw[42],
        "velum": W_raw[43],
        "diagnostics": diag,
    }


def fit_source(measure_fn, vtl_f12, *, deriv_grid=(0.0, 0.5, 1.0, 2.0, 3.0),
               skew_grid=(0.0, 0.4, 0.8), asp_grid=(0.0,), f2_weight=0.3,
               max_weight=0.5, refine_rounds=2):
    """Fit the per-speaker glottal SOURCE calibration (``[source]``,
    model.cpp ``Speaker::SourceCal``) against an external synthesizer's
    audio-level formants — the source-spectrum analogue of
    :func:`fit_tract_affine`.

    A fitted tube map makes the *transfer function* match, but audio-LPC
    formants also see the glottal source spectrum: with VTL-imported
    speakers our kinematic source's steeper spectral tilt biases the
    all-pole fit toward f0, reading F1 low even where the transfer
    function's F1 matches.  This fit
    searches the source's derivative mix (spectral tilt), skew offset
    (closure sharpness) and aspiration gain to minimize

        mean |log(F1_ours / F1_ext)| + f2_weight * mean |log(F2 ratio)|

    over the phone set: F1 driven to match, F2 penalized so the tract
    fit's gains are preserved.

    ``measure_fn(source_dict) -> {phone: (f1_hz, f2_hz)}`` must render a
    speaker with the candidate ``[source]`` values and measure formants
    with the SAME estimator used for ``vtl_f12`` (phone -> (f1, f2)).
    Coarse grid then ``refine_rounds`` of half-step coordinate descent.
    Returns the best source dict plus ``diagnostics``.
    """
    import numpy as np

    phones = list(vtl_f12)

    # beyond this, an "F2" change is a pole-tracking jump (the LPC fit
    # lost the resonance and reported a different pole), not a shift —
    # hard-penalized so the committed speaker keeps its formants trackable
    jump = np.log(1.6)

    def objective(meas):
        e1, e2 = [], []
        for ph in phones:
            f1, f2 = meas[ph][0], meas[ph][1]
            v1, v2 = vtl_f12[ph][0], vtl_f12[ph][1]
            if np.isfinite(f1) and v1 > 0:
                e1.append(abs(np.log(f1 / v1)))
            else:  # a vanished F1 must never look like an improvement
                e1.append(1.0)
            if np.isfinite(f2) and np.isfinite(v2) and f2 > 0 and v2 > 0:
                d2 = abs(np.log(f2 / v2))
                e2.append(d2 if d2 <= jump else d2 + 1.0 / f2_weight)
            else:
                e2.append(jump + 1.0 / f2_weight)  # vanished F2 = jump
        # the max term balances opposing per-phone residuals (close vowels
        # overshoot while mid vowels undershoot a global source change):
        # minimizing mean alone parks one phone far off
        return float(np.mean(e1) + max_weight * np.max(e1)
                     + f2_weight * np.mean(e2 or [0.0]))

    tried = {}

    def evaluate(d, s, a):
        key = (round(d, 6), round(s, 6), round(a, 6))
        if key not in tried:
            meas = measure_fn({"deriv_mix": d, "skew_offset": s,
                               "aspiration_db": a})
            tried[key] = (objective(meas), meas)
        return tried[key]

    best = None
    for d in deriv_grid:
        for s in skew_grid:
            for a in asp_grid:
                err, meas = evaluate(d, s, a)
                if best is None or err < best[0]:
                    best = (err, (d, s, a), meas)

    steps = [0.5 * (deriv_grid[1] - deriv_grid[0]) if len(deriv_grid) > 1
             else 0.25,
             0.5 * (skew_grid[1] - skew_grid[0]) if len(skew_grid) > 1
             else 0.2,
             0.5 * (asp_grid[1] - asp_grid[0]) if len(asp_grid) > 1
             else 0.0]
    for _ in range(refine_rounds):
        err0, (d, s, a), _meas = best
        for axis, step in enumerate(steps):
            if step == 0.0:
                continue
            for sign in (-1.0, 1.0):
                cand = [d, s, a]
                cand[axis] = max(0.0, cand[axis] + sign * step) \
                    if axis == 0 else cand[axis] + sign * step
                err, meas = evaluate(*cand)
                if err < best[0]:
                    best = (err, tuple(cand), meas)
        if best[0] >= err0 - 1e-6:
            steps = [0.5 * st for st in steps]

    err, (d, s, a), meas = best
    return {
        "deriv_mix": float(d), "skew_offset": float(s),
        "aspiration_db": float(a),
        "diagnostics": {
            "objective": round(err, 4),
            "n_evaluations": len(tried),
            "f2_weight": f2_weight,
            "fitted_f12": {ph: [round(float(v), 1) for v in meas[ph]]
                           for ph in phones},
        },
    }


def source_ini_lines(source):
    """Render a :func:`fit_source` result (or a plain dict with
    ``deriv_mix`` / ``skew_offset`` / ``aspiration_db``) as INI lines."""
    lines = ["", "[source]"]
    for key in ("deriv_mix", "skew_offset", "aspiration_db"):
        v = float(source.get(key, 0.0))
        if v != 0.0:
            lines.append(f"{key} = {v:.12g}")
    return lines if len(lines) > 2 else []


def tract_affine_ini_lines(fit):
    """Render a :func:`fit_tract_affine` result as INI lines."""
    lines = ["", "[tract_affine]"]
    for i, row in enumerate(fit["area"]):
        lines.append("area " + str(i) + " "
                     + " ".join(f"{v:.12g}" for v in row))
    for key in ("length", "incisor", "tongue_tip", "velum"):
        lines.append(key + " " + " ".join(f"{v:.12g}" for v in fit[key]))
    return lines


def import_speaker(src, dst, *, name=None, base_length_cm=None,
                   voiceless=(), tube_fit=None, source=None):
    """Convert a VTL XML speaker file to a paule_tpu INI speaker file.

    ``tube_fit``: optional :func:`fit_tract_affine` result to embed as the
    speaker's ``[tract_affine]`` fitted tube map.
    ``source``: optional :func:`fit_source` result to embed as the
    speaker's ``[source]`` glottal-source calibration.
    """
    parsed = parse_vtl_speaker(src)
    text = to_ini(parsed, name=name, base_length_cm=base_length_cm,
                  voiceless=voiceless)
    if tube_fit is not None:
        text += "\n".join(tract_affine_ini_lines(tube_fit)) + "\n"
    if source is not None:
        lines = source_ini_lines(source)
        if lines:
            text += "\n".join(lines) + "\n"
    with open(str(dst), "w") as fh:
        fh.write(text)
    return dst
