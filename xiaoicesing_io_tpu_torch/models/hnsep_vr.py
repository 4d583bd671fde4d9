"""Vocal-remover harmonic/noise separator (``hnsep: vr``): the band-split
cascaded 2-D CNN of the JAX package's ``models/hnsep_vr.py`` over the
complex STFT (real and imaginary parts stacked as channels), with its ASPP
dilation pyramid, BiLSTM bottleneck and bounded complex mask.

The modules keep the reference's names (``stg1_low_band_net.0.enc1.conv.0``,
``...lstm_dec2.lstm.weight_ih_l0``, ``out.weight``, ...), so the reference
``model.pt`` loads with ``load_state_dict``.  Layout NCHW: H is the
frequency bin, W the frame.  The net runs on the card in f32 with TF32 off
(the JAX runner applies f32 parameters); the STFT, the frame padding and
the inverse STFT run on the host in numpy, as in JAX.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import exact_f32, load_reference_weights, resolve_device


class Conv2DBNActiv(nn.Module):
    """Conv (no bias) -> BatchNorm (eps 1e-5, inference statistics) -> activation."""

    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1, activ=nn.ReLU):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, ksize, stride, pad, dilation, bias=False),
            nn.BatchNorm2d(nout), activ())

    def forward(self, x):
        return self.conv(x)


class Encoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, activ=nn.LeakyReLU):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, stride, pad, activ=activ)
        self.conv2 = Conv2DBNActiv(nout, nout, ksize, 1, pad, activ=activ)

    def forward(self, x):
        return self.conv2(self.conv1(x))


def crop_center(skip: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``skip`` cut to ``like``'s frame count about its centre."""
    if skip.shape[3] == like.shape[3]:
        return skip
    s = (skip.shape[3] - like.shape[3]) // 2
    return skip[:, :, :, s: s + like.shape[3]]


class Decoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, activ=nn.ReLU):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, 1, pad, activ=activ)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if skip is not None:
            x = torch.cat([x, crop_center(skip, x)], dim=1)
        return self.conv1(x)


class ASPPModule(nn.Module):
    """Anisotropic dilations, (frequency, frame) pairs."""

    def __init__(self, nin, nout, dilations=((4, 2), (8, 4), (12, 6)), activ=nn.ReLU):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   Conv2DBNActiv(nin, nout, 1, 1, 0, activ=activ))
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0, activ=activ)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0], dilations[0], activ=activ)
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1], dilations[1], activ=activ)
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2], dilations[2], activ=activ)
        self.bottleneck = Conv2DBNActiv(nout * 5, nout, 1, 1, 0, activ=activ)

    def forward(self, x):
        # the pooled branch is one row; align_corners bilinear to H rows repeats it
        feat1 = self.conv1(x).expand(-1, -1, x.shape[2], -1)
        out = torch.cat([feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)],
                        dim=1)
        return self.bottleneck(out)


class LSTMModule(nn.Module):
    def __init__(self, nin_conv, nin_lstm, nout_lstm):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(input_size=nin_lstm, hidden_size=nout_lstm // 2, bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm), nn.BatchNorm1d(nin_lstm),
                                   nn.ReLU())

    def forward(self, x):
        """[N, C, bins, frames] -> [N, 1, bins, frames]"""
        n, _, nbins, nframes = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)  # frames, N, bins
        h, _ = self.lstm(h)
        h = self.dense(h.reshape(-1, h.shape[-1]))
        return h.reshape(nframes, n, 1, nbins).permute(1, 2, 3, 0)


class BaseNet(nn.Module):
    def __init__(self, nin, nout, nin_lstm, nout_lstm, dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = Encoder(nout, nout * 2, 3, 2, 1)
        self.enc3 = Encoder(nout * 2, nout * 4, 3, 2, 1)
        self.enc4 = Encoder(nout * 4, nout * 6, 3, 2, 1)
        self.enc5 = Encoder(nout * 6, nout * 8, 3, 2, 1)
        self.aspp = ASPPModule(nout * 8, nout * 8, dilations)
        self.dec4 = Decoder(nout * (6 + 8), nout * 6, 3, 1, 1)
        self.dec3 = Decoder(nout * (4 + 6), nout * 4, 3, 1, 1)
        self.dec2 = Decoder(nout * (2 + 4), nout * 2, 3, 1, 1)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = Decoder(nout * (1 + 2) + 1, nout * 1, 3, 1, 1)

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNet(nn.Module):
    """The complex-mask cascade.  ``aux_out`` is the reference's training
    head: it is loaded with the checkpoint and never run."""

    def __init__(self, n_fft: int, nout: int = 32, nout_lstm: int = 128, is_mono: bool = False):
        super().__init__()
        self.n_fft = n_fft
        self.is_mono = is_mono
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        nin_lstm = self.max_bin // 2
        nin = 2 if is_mono else 4
        self.stg1_low_band_net = nn.Sequential(
            BaseNet(nin, nout // 2, nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0))
        self.stg1_high_band_net = BaseNet(nin, nout // 4, nin_lstm // 2, nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(
            BaseNet(nout // 4 + nin, nout, nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout, nout // 2, 1, 1, 0))
        self.stg2_high_band_net = BaseNet(nout // 4 + nin, nout // 2, nin_lstm // 2,
                                          nout_lstm // 2)
        self.stg3_full_band_net = BaseNet(3 * nout // 4 + nin, nout, nin_lstm, nout_lstm)
        self.out = nn.Conv2d(nout, nin, 1, bias=False)
        self.aux_out = nn.Conv2d(3 * nout // 4, nin, 1, bias=False)

    def forward(self, spec_ri: torch.Tensor) -> torch.Tensor:
        """spec_ri: [B, 2C, bins, frames], real then imaginary channels (C = 1
        mono, 2 stereo) -> the bounded complex mask in the same layout."""
        x = spec_ri[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1))
        mask = self.out(f3)
        c = mask.shape[1] // 2
        re, im = mask[:, :c], mask[:, c:]
        mag = torch.sqrt(re ** 2 + im ** 2)
        scale = torch.tanh(mag) / (mag + 1e-8)
        out = torch.cat([re * scale, im * scale], dim=1)
        # replicate the last bin up to n_fft // 2 + 1
        return F.pad(out, (0, 0, 0, self.output_bin - out.shape[2]), mode="replicate")


class VocalRemover:
    """``hnsep: vr``: waveform -> harmonic part.  Reads ``config.yaml``
    (``n_fft``, ``hop_length``, ``n_out``, ``n_out_lstm``, ``is_mono``) beside
    ``model.pt``; the net runs on ``device`` (default CUDA)."""

    def __init__(self, model_path, device=None):
        import yaml

        self.device = resolve_device(device)
        model_path = Path(model_path)
        with open(model_path.with_name("config.yaml")) as f:
            args = yaml.safe_load(f)
        self.n_fft = args["n_fft"]
        self.hop_length = args["hop_length"]
        self.is_mono = args.get("is_mono", False)
        self.model = CascadedNet(self.n_fft, nout=args.get("n_out", 32),
                                 nout_lstm=args.get("n_out_lstm", 128), is_mono=self.is_mono)
        state_dict = torch.load(model_path, map_location="cpu", weights_only=True)
        load_reference_weights(self.model, state_dict, unused=("aux_out.",))
        self.model.to(self.device).eval()

    def spectrogram(self, waveform: np.ndarray):
        """The waveform padded to a multiple of 32 frames and its STFT: (padded
        length, left pad, complex spectrum [bins, frames], window, the net's
        real/imaginary input [1, 2C, bins, frames])."""
        hop = self.hop_length
        n = len(waveform)
        n_frames = n // hop + 1
        pad_total = (32 * (n_frames // 32 + 1) - 1) * hop - n
        left = (pad_total // 2 // hop) * hop
        x = np.pad(waveform, (left, pad_total - left))
        window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(self.n_fft) / self.n_fft)
        # torch.stft(center=True, pad_mode="constant")
        xp = np.pad(x, (self.n_fft // 2, self.n_fft // 2))
        idx = np.arange(self.n_fft)[None, :] + hop * np.arange(
            1 + (len(xp) - self.n_fft) // hop)[:, None]
        spec = np.fft.rfft(xp[idx] * window[None, :], axis=1).T
        chans = 1 if self.is_mono else 2
        ri = np.stack([spec.real] * chans + [spec.imag] * chans, 0)[None]
        return len(x), left, spec, window, ri.astype(np.float32)

    @torch.no_grad()
    def mask(self, ri: np.ndarray) -> np.ndarray:
        """The net on ``device``: [1, 2C, bins, frames] -> the complex mask, same layout."""
        with exact_f32():
            return self.model(torch.from_numpy(ri).to(self.device)).cpu().numpy()

    def predict_harmonic(self, waveform: np.ndarray) -> np.ndarray:
        """waveform [T] -> harmonic waveform [T]."""
        from ..dsp.hnsep import istft_centered

        n_padded, left, spec, window, ri = self.spectrogram(waveform)
        mask = self.mask(ri)
        c = mask.shape[1] // 2
        mask_c = mask[:, :c] + 1j * mask[:, c:]
        pred = (spec[None, None] * mask_c).mean(axis=1)[0]  # the channels' mean
        wav = istft_centered(pred.T, self.n_fft, self.hop_length, window, n_padded)
        return wav[left: left + len(waveform)].astype(np.float32)
