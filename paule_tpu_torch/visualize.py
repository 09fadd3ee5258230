"""Plots and result files of a plan (counterpart of
``paule_tpu/visualize.py``): mel comparison panels, audio, loss curves,
cp plots, per-frame SVGs of the tract and, where ``ffmpeg`` is on the
``PATH``, mp4 animations of them.  matplotlib is imported inside the
functions that draw, so that the module imports without it."""

import os
import pickle
import shutil
import subprocess

import numpy as np

from .dsp import audio as audio_io
from .ops.normalize import inv_normalize_cp
from . import synth


def _specshow(ax, mel, sr=44100, hop=220):
    """A mel ``(T, 60)`` on time x mel-band axes."""
    import matplotlib.cm as cm

    extent = [0, mel.shape[0] * hop / sr, 0, mel.shape[1]]
    ax.imshow(mel.T, origin="lower", aspect="auto", extent=extent,
              cmap=cm.magma)


def plot_mels(file_name, target_mel, initial_pred_mel, initial_prod_mel,
              pred_mel, prod_mel):
    """Six mel panels: target, initial produced and predicted, planned
    predicted and produced, target; ``file_name=True`` shows them, else
    they are written to ``file_name``."""
    import matplotlib.pyplot as plt

    panels = [
        (target_mel, "Target"),
        (initial_prod_mel, "Initial Produced"),
        (initial_pred_mel, "Initial Prediction"),
        (pred_mel, "Planned Prediction"),
        (prod_mel, "Planned Produced"),
        (target_mel, "Target"),
    ]
    fig, axes = plt.subplots(nrows=6, figsize=(15, 18), facecolor="white")
    for ax, (mel, title) in zip(axes, panels):
        _specshow(ax, np.asarray(mel))
        ax.set_title(title, fontsize=18)
        ax.set_ylabel("mel band", fontsize=12)
    axes[-1].set_xlabel("Time (s)", fontsize=15)
    fig.tight_layout()
    if file_name is True:
        plt.show()
    else:
        fig.savefig(file_name)
    plt.close(fig)


def plot_cp(cp, file_name):
    """A cp trajectory ``(T, 30)`` in three panels of ten parameters."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 10))
    ax1 = fig.add_axes([0.1, 0.65, 0.8, 0.3], ylim=(-3, 3))
    ax2 = fig.add_axes([0.1, 0.35, 0.8, 0.3], xticklabels=[], sharex=ax1,
                       sharey=ax1)
    ax3 = fig.add_axes([0.1, 0.05, 0.8, 0.3], sharex=ax1, sharey=ax1)
    for ii in range(10):
        ax1.plot(cp[:, ii], label=f"param{ii:0d}")
    for ii in range(10, 20):
        ax2.plot(cp[:, ii], label=f"param{ii:0d}")
    for ii in range(20, 30):
        ax3.plot(cp[:, ii], label=f"param{ii:0d}")
    ax1.legend()
    ax2.legend()
    ax3.legend()
    fig.savefig(file_name, dpi=300)
    plt.close("all")


def plot_mel(mel, file_name):
    """One mel ``(T, 60)`` as an image."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 6))
    plt.imshow(np.asarray(mel).T, aspect="equal", vmin=-5, vmax=20)
    fig.savefig(file_name, dpi=300)
    plt.close("all")


def visualize_results(results, condition="prefix", folder="data"):
    """Write ``<folder>/<condition>_*``: the mel panels, the planned,
    initial and target audio, the loss curves, the named articulators'
    initial, planned and changed trajectories, and per-frame SVGs of the
    initial and planned tract (with mp4 animations where ``ffmpeg`` is
    found) of a :class:`~paule_tpu_torch.planning.results.PlanningResults`
    or of the pickle file holding one."""
    import matplotlib.pyplot as plt

    if isinstance(results, str):
        with open(results, "rb") as pfile:
            results = pickle.load(pfile)

    os.makedirs(folder, exist_ok=True)
    base_name = os.path.join(folder, f"{condition}")

    plot_mels(f"{base_name}_mel.png", results.target_mel,
              results.initial_pred_mel, results.initial_prod_mel,
              results.pred_mel, results.prod_mel)

    audio_io.write(f"{base_name}_planned.wav", results.prod_sig,
                   results.prod_sr)
    audio_io.write(f"{base_name}_initial.wav", results.initial_sig,
                   results.initial_sr)
    if results.target_sig is not None:
        audio_io.write(f"{base_name}_target.wav", results.target_sig,
                       int(results.target_sr))

    def curve(fname, series):
        fig, ax = plt.subplots(figsize=(15, 8), facecolor="white")
        for ys, label, color in series:
            ax.plot(ys, label=label, c=color)
        ax.legend()
        fig.tight_layout()
        fig.savefig(fname)
        plt.close(fig)

    curve(f"{base_name}_loss.png",
          [(results.planned_loss_steps, "planned loss", "C0")])
    curve(f"{base_name}_loss_mel.png",
          [(results.prod_loss_steps, "produced mel loss", "C1"),
           (results.planned_mel_loss_steps, "planned mel loss", "C0")])
    curve(f"{base_name}_loss_subloss.png",
          [(results.vel_loss_steps, "vel loss", "C2"),
           (results.jerk_loss_steps, "jerk loss", "C3")])
    curve(f"{base_name}_loss_semvec.png",
          [(results.pred_semvec_loss_steps, "planned semvec loss", "C0"),
           (results.prod_semvec_loss_steps, "produced semvec loss", "C1")])
    if hasattr(results, "pred_speech_classifier_loss_steps"):
        curve(f"{base_name}_loss_speech_classifier.png",
              [(results.pred_speech_classifier_loss_steps,
                "planned speech classifier loss", "C0"),
               (np.array(results.prod_speech_classifier_loss_steps) / 10.0,
                "produced speech classifier loss", "C1")])

    # the named articulators' trajectories
    named = [(3, "JA"), (8, "TCX"), (9, "TCY"), (10, "TTX"), (11, "TTY"),
             (12, "TBX"), (13, "TBY"), (14, "TRX"), (15, "TRY"), (19, "f0")]
    fig = plt.figure(figsize=(15, 12))
    ax1 = fig.add_axes([0.1, 0.68, 0.88, 0.30], xticklabels=[])
    ax2 = fig.add_axes([0.1, 0.36, 0.88, 0.30], xticklabels=[], sharex=ax1)
    ax3 = fig.add_axes([0.1, 0.04, 0.88, 0.30], xticklabels=[], sharex=ax1)
    img1, img2 = results.initial_cp, results.planned_cp
    img3 = img2 - img1
    for (idx, label) in named:
        ax1.plot(img1[:, idx : idx + 1], label=label)
        ax2.plot(img2[:, idx : idx + 1], label=label)
        ax3.plot(img3[:, idx : idx + 1], label=label)
    ax1.set_ylabel("initial")
    ax2.set_ylabel("optimized")
    ax3.set_ylabel("difference")
    ax1.legend()
    # axes are placed manually (add_axes); tight_layout would warn
    fig.savefig(f"{base_name}_cps.png")
    plt.close(fig)

    # per-frame SVGs, and their animation
    for which, cp in (("initial", results.initial_cp),
                      ("planned", results.planned_cp)):
        path = f"{base_name}_{which}_svgs/"
        os.makedirs(path, exist_ok=True)
        synth.export_svgs(inv_normalize_cp(cp), path=path)
        if shutil.which("ffmpeg"):
            cmd = (f"cd {path}; ffmpeg -hide_banner -loglevel error -y -r 80 "
                   f"-width 768 -i tract%05d.svg -i ../{condition}_{which}.wav"
                   f" -c:v libx264 -pix_fmt yuv420p "
                   f"../{condition}_{which}_80Hz.mp4")
            if subprocess.call(cmd, shell=True) != 0:
                print(f"WARNING: creating the {which} animation went wrong")
