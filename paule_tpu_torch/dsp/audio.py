"""Audio file IO with the standard library and numpy (counterpart of
``paule_tpu/dsp/audio.py:20-130``).

WAV is read natively (PCM 8/16/24/32-bit and IEEE float, any channel
count) and written as 16-bit PCM.  Other formats go through ``ffmpeg``
when it is installed; without it, reading one raises and writing one
falls back to WAV under the same stem.
"""

import os
import shutil
import struct
import subprocess
import wave

import numpy as np


def read(path):
    """-> ``(float64 signal in [-1, 1], sample rate)``; a file with several
    channels keeps them as ``(n, channels)`` (see :func:`stereo_to_mono`)."""
    if os.path.splitext(path)[1].lower() == ".wav":
        return _read_wav(path)
    return _read_via_ffmpeg(path)


def write(path, sig, samplerate):
    """Write ``sig`` as 16-bit PCM WAV, or through ``ffmpeg`` for another
    extension.  -> the path written (the ``.wav`` fallback without
    ``ffmpeg``)."""
    sig = np.asarray(sig, dtype=np.float64)
    stem, ext = os.path.splitext(path)
    if ext.lower() == ".wav":
        _write_wav(path, sig, samplerate)
        return path
    if not shutil.which("ffmpeg"):
        _write_wav(stem + ".wav", sig, samplerate)
        return stem + ".wav"
    tmp = path + ".tmp.wav"
    _write_wav(tmp, sig, samplerate)
    try:
        subprocess.run(["ffmpeg", "-hide_banner", "-loglevel", "error", "-y",
                        "-i", tmp, path], check=True)
    finally:
        os.unlink(tmp)
    return path


def stereo_to_mono(wave_data, which="both"):
    """``(n, 2)`` -> ``(n,)``: the left or right channel, or their mean."""
    if which == "left":
        return wave_data[:, 0]
    if which == "right":
        return wave_data[:, 1]
    return (wave_data[:, 0] + wave_data[:, 1]) / 2


def _chunks(data):
    """RIFF chunk id -> body, for the chunks after the WAVE header."""
    out = {}
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.setdefault(cid, data[pos + 8:pos + 8 + size])
        pos += 8 + size + (size & 1)
    return out


def _read_wav(path):
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")
    chunks = _chunks(data)
    if b"fmt " not in chunks or b"data" not in chunks:
        raise ValueError(f"{path}: missing fmt/data chunk")
    fmt_tag, channels, sr, _rate, _align, bits = struct.unpack(
        "<HHIIHH", chunks[b"fmt "][:16])
    raw = chunks[b"data"]
    if fmt_tag == 0xFFFE:                       # WAVE_FORMAT_EXTENSIBLE
        fmt_tag = 1 if bits in (16, 24, 32) else 3
    if fmt_tag == 3:                            # IEEE float
        sig = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
        sig = sig.astype(np.float64)
    elif fmt_tag == 1:                          # PCM
        if bits == 8:
            sig = (np.frombuffer(raw, dtype=np.uint8) - 128.0) / 128.0
        elif bits == 16:
            sig = np.frombuffer(raw, dtype="<i2") / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            sig = vals / float(1 << 23)
        elif bits == 32:
            sig = np.frombuffer(raw, dtype="<i4") / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag {fmt_tag}")
    sig = np.asarray(sig, dtype=np.float64)
    if channels > 1:
        sig = sig.reshape(-1, channels)
    return sig, sr


def _write_wav(path, sig, samplerate):
    pcm = (np.clip(sig, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        wf.setsampwidth(2)
        wf.setframerate(int(samplerate))
        wf.writeframes(pcm.tobytes())


def _read_via_ffmpeg(path):
    if not shutil.which("ffmpeg"):
        raise RuntimeError(
            f"cannot decode {path!r}: only WAV is read natively and ffmpeg "
            "is not installed; pass (signal, samplerate) instead")
    out = subprocess.run(
        ["ffmpeg", "-hide_banner", "-loglevel", "error", "-i", path,
         "-f", "f64le", "-acodec", "pcm_f64le", "-"],
        check=True, capture_output=True).stdout
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-show_entries",
         "stream=sample_rate,channels", "-of", "csv=p=0", path],
        check=True, capture_output=True, text=True).stdout.strip().split(",")
    sr, channels = int(probe[0]), int(probe[1])
    sig = np.frombuffer(out, dtype="<f8").astype(np.float64)
    if channels > 1:
        sig = sig.reshape(-1, channels)
    return sig, sr
