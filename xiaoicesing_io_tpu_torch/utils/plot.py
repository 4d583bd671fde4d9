"""Validation figures and audio for TensorBoard (counterpart of the JAX
package's ``utils/plot.py``): a spectrogram, the mel triptych (|error| / GT
/ prediction), curves, duration alignment, pitch against notes, audio
through a writer, and the binarizers' distribution bar chart.  matplotlib and tensorboardX
are imported when first used; :func:`figures_available` says up front
whether matplotlib is installed.
"""

from __future__ import annotations

import importlib.util

import numpy as np


def figures_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def distribution_to_figure(title, x_label, y_label, items, values, zoom=0.8):
    """A bar chart of ``values`` over ``items``; None without matplotlib."""
    if not figures_available():
        return None
    plt = _plt()
    fig = plt.figure(figsize=(int(len(items) * zoom), 10))
    plt.bar(x=items, height=values)
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    plt.title(title)
    return fig


def spec_to_figure(spec, vmin=None, vmax=None, title=None):
    """``spec`` ``[T, M]`` as a pcolor image, frames along x."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 6))
    plt.pcolor(np.asarray(spec).T, vmin=vmin, vmax=vmax)
    if title:
        plt.title(title)
    plt.tight_layout()
    return fig


def spec_diff_to_figure(gt_spec, pred_spec, vmin=None, vmax=None, title=None):
    plt = _plt()
    gt, pred = np.asarray(gt_spec), np.asarray(pred_spec)
    fig, axes = plt.subplots(3, 1, figsize=(12, 9), sharex=True)
    axes[0].pcolor(np.abs(pred - gt).T)
    axes[0].set_title(title or "spec")
    axes[0].set_ylabel("|error|")
    axes[1].pcolor(gt.T, vmin=vmin, vmax=vmax)
    axes[1].set_ylabel("GT")
    axes[2].pcolor(pred.T, vmin=vmin, vmax=vmax)
    axes[2].set_ylabel("pred")
    plt.tight_layout()
    return fig


def curve_to_figure(gt_curve, pred_curve=None, title=None):
    plt = _plt()
    fig = plt.figure()
    plt.plot(np.asarray(gt_curve), color="b", label="gt")
    if pred_curve is not None:
        plt.plot(np.asarray(pred_curve), color="r", label="pred")
    plt.grid(axis="y")
    plt.legend()
    if title:
        plt.title(title)
    plt.tight_layout()
    return fig


def dur_to_figure(dur_gt, dur_pred, txt):
    plt = _plt()
    gt_pos = np.cumsum(np.asarray(dur_gt).astype(np.int64))
    pred_pos = np.cumsum(np.asarray(dur_pred).astype(np.int64))
    fig = plt.figure(figsize=(max(12, min(48, len(txt) // 2)), 8))
    plt.vlines(gt_pos, 12, 22, colors="b", label="gt")
    plt.vlines(pred_pos, 0, 10, colors="r", label="pred")
    for i in range(len(txt)):
        shift = 0.6 if i % 2 else 1.5
        plt.text((gt_pos[i - 1] + gt_pos[i]) / 2 if i > 0 else gt_pos[0] / 2,
                 12 + shift, txt[i], size=16, horizontalalignment="center")
        plt.text((pred_pos[i - 1] + pred_pos[i]) / 2 if i > 0 else pred_pos[0] / 2,
                 shift, txt[i], size=16, horizontalalignment="center")
    plt.yticks([])
    plt.legend()
    plt.tight_layout()
    return fig


def pitch_notes_to_figure(pitch_gt, pitch_pred=None, note_midi=None, note_dur=None,
                          note_rest=None):
    plt = _plt()
    fig = plt.figure()
    if note_midi is not None and note_dur is not None:
        bounds = np.cumsum(np.asarray(note_dur))
        starts = np.concatenate([[0], bounds[:-1]])
        for i, (s, e, m) in enumerate(zip(starts, bounds, np.asarray(note_midi))):
            if not (note_rest is not None and bool(np.asarray(note_rest)[i])):
                plt.fill_between([s, e], m - 0.5, m + 0.5, color="gray", alpha=0.3)
    plt.plot(np.asarray(pitch_gt), color="b", label="gt")
    if pitch_pred is not None:
        plt.plot(np.asarray(pitch_pred), color="r", label="pred")
    plt.legend()
    plt.tight_layout()
    return fig


def tb_add_audio(writer, tag, wav, step, sample_rate):
    """``writer.add_audio``; where tensorboardX cannot encode the clip
    without the optional ``soundfile``, the audio summary is built from a
    PCM16 WAV of the stdlib ``wave`` module."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    try:
        writer.add_audio(tag, wav[:, None], step, sample_rate=sample_rate)
        return
    except ImportError:
        pass
    import io
    import wave as _wave

    from tensorboardX.proto.summary_pb2 import Summary

    buf = io.BytesIO()
    with _wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes((np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes())
    audio = Summary.Audio(sample_rate=float(sample_rate), num_channels=1,
                          length_frames=len(wav), encoded_audio_string=buf.getvalue(),
                          content_type="audio/wav")
    writer._get_file_writer().add_summary(
        Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)
