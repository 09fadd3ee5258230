"""Reference (torch) checkpoints -> parameter trees in the JAX package's
layout, which :func:`paule_tpu_torch.release.load_into` takes (the port's
own copy of ``paule_tpu/models/torch_convert.py:24-157``: forward, inverse,
embedder, generator, critic, linear classifier).

* linear:  torch ``weight (out, in)``      -> ``w (in, out)``
* conv1d:  torch ``weight (out, in/g, k)`` -> ``w (k, in/g, out)``
* LSTM:    torch ``weight_ih_l{i} (4H, in)`` -> ``w_ih (in, 4H)``, the two
  biases summed into one ``b (4H,)``; gate order i, f, g, o in both
* batch norm: ``weight``, ``bias``, ``running_mean``, ``running_var`` ->
  ``scale``, ``bias``, ``mean``, ``var``; instance norm: ``weight``,
  ``bias`` -> ``scale``, ``bias``

Leaves are numpy arrays in the file's dtype.
"""

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def t_linear(sd, prefix):
    return {"w": _np(sd[f"{prefix}.weight"]).T.copy(),
            "b": _np(sd[f"{prefix}.bias"]).copy()}


def t_conv1d(sd, prefix):
    return {"w": np.transpose(_np(sd[f"{prefix}.weight"]), (2, 1, 0)).copy(),
            "b": _np(sd[f"{prefix}.bias"]).copy()}


def t_lstm(sd, prefix, num_layers):
    return [{"w_ih": _np(sd[f"{prefix}.weight_ih_l{i}"]).T.copy(),
             "w_hh": _np(sd[f"{prefix}.weight_hh_l{i}"]).T.copy(),
             "b": (_np(sd[f"{prefix}.bias_ih_l{i}"])
                   + _np(sd[f"{prefix}.bias_hh_l{i}"]))}
            for i in range(num_layers)]


def t_batchnorm(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]).copy(),
            "bias": _np(sd[f"{prefix}.bias"]).copy(),
            "mean": _np(sd[f"{prefix}.running_mean"]).copy(),
            "var": _np(sd[f"{prefix}.running_var"]).copy()}


def t_instancenorm(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]).copy(),
            "bias": _np(sd[f"{prefix}.bias"]).copy()}


def _count(sd, pattern):
    """How many ``n = 0, 1, ...`` have a key starting with
    ``pattern.format(n)``."""
    n = 0
    while any(k.startswith(pattern.format(n)) for k in sd):
        n += 1
    return n


def convert_forward_model(sd):
    return {"lstm": t_lstm(sd, "lstm", _count(sd, "lstm.weight_ih_l{}")),
            "post_linear": t_linear(sd, "post_linear")}


def convert_embedding_model(sd):
    params = {"lstm": t_lstm(sd, "lstm", _count(sd, "lstm.weight_ih_l{}")),
              "linear_mapping": t_linear(sd, "linear_mapping")}
    if "post_linear.weight" in sd:
        params["post_linear"] = t_linear(sd, "post_linear")
    return params


def convert_inverse_model(sd):
    params = {
        "mel_blocks": [
            {"convs": [
                t_conv1d(sd, f"MelBlocks.{i}.ConvLayers.{j}")
                for j in range(_count(sd, f"MelBlocks.{i}.ConvLayers.{{}}."))
            ]}
            for i in range(_count(sd, "MelBlocks.{}."))
        ],
        "lstm": t_lstm(sd, "lstm", _count(sd, "lstm.weight_ih_l{}")),
        "post_linear": t_linear(sd, "post_linear"),
        "resid_blocks": [
            {"conv1": t_conv1d(sd, f"ResidualConvBlocks.{i}.band_conv1d_1"),
             "conv2": t_conv1d(sd, f"ResidualConvBlocks.{i}.band_conv1d_2")}
            for i in range(_count(sd, "ResidualConvBlocks.{}."))
        ],
    }
    if "resid_weighting.weight" in sd:
        params["resid_weighting"] = t_conv1d(sd, "resid_weighting")
    return params


def convert_generator(sd):
    return {
        "fully_connected": t_linear(sd, "fully_connected"),
        "blocks": [
            {"conv": t_conv1d(sd, f"res_blocks.{i}.0"),
             "bn": t_batchnorm(sd, f"res_blocks.{i}.1")}
            for i in range(_count(sd, "res_blocks.{}."))
        ],
        "post_linear": t_linear(sd, "post_linear"),
        "final_smoothing": t_conv1d(sd, "final_smoothing"),
    }


def convert_critic(sd):
    return {
        "inital_linear": t_linear(sd, "inital_linear"),
        "blocks": [
            {"conv": t_conv1d(sd, f"res_blocks.{i}.0"),
             "in_norm": t_instancenorm(sd, f"res_blocks.{i}.1")}
            for i in range(_count(sd, "res_blocks.{}."))
        ],
    }


def convert_linear_classifier(sd):
    return {"linear": t_linear(sd, "linear")}


#: pretrained-model kind -> converter
CONVERTERS = {
    "forward": convert_forward_model,
    "inverse": convert_inverse_model,
    "embedder": convert_embedding_model,
    "generator": convert_generator,
    "critic": convert_critic,
    "linear_classifier": convert_linear_classifier,
}


def load_state_dict(path):
    """A reference ``.pt`` state dict, read without unpickling code."""
    return torch.load(path, map_location="cpu", weights_only=True)


def convert(kind, state_dict_or_path):
    """A state dict, or the path of a ``.pt`` file holding one, of a model
    of ``kind`` (a key of :data:`CONVERTERS`) -> its JAX-layout tree."""
    sd = state_dict_or_path
    if isinstance(sd, (str, bytes)):
        sd = load_state_dict(sd)
    return CONVERTERS[kind](sd)
