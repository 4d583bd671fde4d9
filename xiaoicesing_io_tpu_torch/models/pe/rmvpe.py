"""RMVPE neural pitch extractor (``pe: rmvpe``): the deep U-Net of the JAX
package's ``models/pe/rmvpe.py`` (a 5-level encoder of 4 ``ConvBlockRes``
a level with 2x2 average pooling, 4 intermediate blocks, a mirrored
transposed-conv decoder), a 3-channel head conv, a BiGRU and a linear
layer -> 360 sigmoid cent classes over a 16 kHz HTK mel (128 bins, window
1024, hop 160, 30-8000 Hz); decoded by a local average about the argmax (or
a Viterbi path), cents -> Hz, unvoiced under a threshold.

``E2E0`` keeps the reference's names (``unet.encoder.layers.*``,
``unet.decoder.layers.*.conv1.0`` as ``ConvTranspose2d``, ``cnn``,
``fc.0.gru``, ``fc.1``), so the reference ``model.pt`` loads with
``load_state_dict``.  The reference's ``TimbreFilter`` (``unet.tf``) is
loaded and never run, as in the reference's forward pass.  The net runs on
the card in f32 with TF32 off (the JAX runner applies f32 parameters); the
resampling, the centred mel and the decoding run on the host, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ...utils import exact_f32, load_reference_weights, resolve_device

SAMPLE_RATE = 16000
N_CLASS = 360
N_MELS = 128
MEL_FMIN = 30
MEL_FMAX = 8000
WINDOW_LENGTH = 1024
CONST = 1997.3794084376191


class ConvBlockRes(nn.Module):
    def __init__(self, in_channels, out_channels, momentum=0.01):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=momentum), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, 1, 1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=momentum), nn.ReLU())
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x):
        return self.conv(x) + (x if self.shortcut is None else self.shortcut(x))


class ResEncoderBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, n_blocks=1, momentum=0.01):
        super().__init__()
        self.conv = nn.ModuleList([ConvBlockRes(in_channels, out_channels, momentum)] + [
            ConvBlockRes(out_channels, out_channels, momentum) for _ in range(n_blocks - 1)])
        self.pool = nn.AvgPool2d(kernel_size) if kernel_size is not None else None

    def forward(self, x):
        for conv in self.conv:
            x = conv(x)
        return x if self.pool is None else (x, self.pool(x))


class Encoder(nn.Module):
    def __init__(self, in_channels, in_size, n_encoders, kernel_size, n_blocks,
                 out_channels=16, momentum=0.01):
        super().__init__()
        self.bn = nn.BatchNorm2d(in_channels, momentum=momentum)
        self.layers = nn.ModuleList()
        self.latent_channels = []
        for _ in range(n_encoders):
            self.layers.append(ResEncoderBlock(in_channels, out_channels, kernel_size, n_blocks,
                                               momentum))
            self.latent_channels.append([out_channels, in_size])
            in_channels, out_channels, in_size = out_channels, out_channels * 2, in_size // 2
        self.out_channel = out_channels

    def forward(self, x):
        skips = []
        x = self.bn(x)
        for layer in self.layers:
            skip, x = layer(x)
            skips.append(skip)
        return x, skips


class Intermediate(nn.Module):
    def __init__(self, in_channels, out_channels, n_inters, n_blocks, momentum=0.01):
        super().__init__()
        self.layers = nn.ModuleList(
            [ResEncoderBlock(in_channels, out_channels, None, n_blocks, momentum)]
            + [ResEncoderBlock(out_channels, out_channels, None, n_blocks, momentum)
               for _ in range(n_inters - 1)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ResDecoderBlock(nn.Module):
    def __init__(self, in_channels, out_channels, stride, n_blocks=1, momentum=0.01):
        super().__init__()
        out_padding = (0, 1) if tuple(stride) == (1, 2) else (1, 1)
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(in_channels, out_channels, 3, stride, 1, out_padding, bias=False),
            nn.BatchNorm2d(out_channels, momentum=momentum), nn.ReLU())
        self.conv2 = nn.ModuleList([ConvBlockRes(out_channels * 2, out_channels, momentum)] + [
            ConvBlockRes(out_channels, out_channels, momentum) for _ in range(n_blocks - 1)])

    def forward(self, x, skip):
        x = torch.cat([self.conv1(x), skip], dim=1)
        for conv in self.conv2:
            x = conv(x)
        return x


class Decoder(nn.Module):
    def __init__(self, in_channels, n_decoders, stride, n_blocks, momentum=0.01):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(n_decoders):
            self.layers.append(ResDecoderBlock(in_channels, in_channels // 2, stride, n_blocks,
                                               momentum))
            in_channels //= 2

    def forward(self, x, skips):
        for i, layer in enumerate(self.layers):
            x = layer(x, skips[-1 - i])
        return x


class TimbreFilter(nn.Module):
    """Weights of the reference checkpoint that its forward pass never uses."""

    def __init__(self, latent_channels):
        super().__init__()
        self.layers = nn.ModuleList([ConvBlockRes(c, c) for c, _ in latent_channels])


class DeepUnet0(nn.Module):
    def __init__(self, kernel_size, n_blocks, en_de_layers=5, inter_layers=4, in_channels=1,
                 en_out_channels=16):
        super().__init__()
        self.encoder = Encoder(in_channels, N_MELS, en_de_layers, kernel_size, n_blocks,
                               en_out_channels)
        self.intermediate = Intermediate(self.encoder.out_channel // 2,
                                         self.encoder.out_channel, inter_layers, n_blocks)
        self.tf = TimbreFilter(self.encoder.latent_channels)
        self.decoder = Decoder(self.encoder.out_channel, en_de_layers, kernel_size, n_blocks)

    def forward(self, x):
        x, skips = self.encoder(x)
        return self.decoder(self.intermediate(x), skips)


class BiGRU(nn.Module):
    def __init__(self, input_features, hidden_features, num_layers):
        super().__init__()
        self.gru = nn.GRU(input_features, hidden_features, num_layers=num_layers,
                          batch_first=True, bidirectional=True)

    def forward(self, x):
        return self.gru(x)[0]


class E2E0(nn.Module):
    """``E2E0(4, 1, (2, 2))`` of the reference: mel [B, 128, T] -> [B, T, 360]
    sigmoid cent-class salience."""

    def __init__(self, n_blocks=4, n_gru=1, kernel_size=(2, 2), en_de_layers=5, inter_layers=4,
                 in_channels=1, en_out_channels=16):
        super().__init__()
        self.unet = DeepUnet0(kernel_size, n_blocks, en_de_layers, inter_layers, in_channels,
                              en_out_channels)
        self.cnn = nn.Conv2d(en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(BiGRU(3 * N_MELS, 256, n_gru), nn.Linear(512, N_CLASS),
                                nn.Dropout(0.25), nn.Sigmoid())

    def forward(self, mel):
        x = mel.transpose(-1, -2).unsqueeze(1)
        x = self.cnn(self.unet(x)).transpose(1, 2).flatten(-2)
        return self.fc(x)

    @staticmethod
    def from_state_dict(state_dict) -> "E2E0":
        """An ``E2E0`` of the depth and width the state dict holds, loaded."""
        def count(prefix):
            return len({k[len(prefix):].split(".")[0] for k in state_dict if k.startswith(prefix)})

        model = E2E0(n_blocks=count("unet.encoder.layers.0.conv."),
                     en_de_layers=count("unet.encoder.layers."),
                     inter_layers=count("unet.intermediate.layers."),
                     en_out_channels=state_dict["cnn.weight"].shape[1])
        load_reference_weights(model, state_dict, unused=("unet.tf.",))
        return model


# ---------------------------------------------------------------------------
# decoding, on the host
# ---------------------------------------------------------------------------

def to_local_average_f0(hidden: np.ndarray, center: Optional[np.ndarray] = None,
                        thred: float = 0.03) -> np.ndarray:
    """hidden: [T, N_CLASS] -> f0 [T] (0 where unvoiced)."""
    idx = np.arange(N_CLASS)[None, :]
    idx_cents = idx * 20 + CONST
    if center is None:
        center = np.argmax(hidden, axis=1, keepdims=True)
    start = np.clip(center - 4, 0, None)
    end = np.clip(center + 5, None, N_CLASS)
    weights = hidden * ((idx >= start) & (idx < end))
    product_sum = np.sum(weights * idx_cents, axis=1)
    weight_sum = np.sum(weights, axis=1)
    cents = product_sum / (weight_sum + (weight_sum == 0))
    f0 = 10 * 2 ** (cents / 1200)
    uv = hidden.max(axis=1) < thred
    return (f0 * ~uv).astype(np.float32)


def to_viterbi_f0(hidden: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """Viterbi-smoothed decoding (``librosa.sequence.viterbi`` equivalent)."""
    xx, yy = np.meshgrid(range(N_CLASS), range(N_CLASS))
    transition = np.maximum(30 - np.abs(xx - yy), 0).astype(np.float64)
    transition /= transition.sum(axis=1, keepdims=True)
    log_trans = np.log(np.maximum(transition, 1e-12))
    prob = hidden.astype(np.float64)
    prob = prob / np.maximum(prob.sum(axis=1, keepdims=True), 1e-12)
    log_prob = np.log(np.maximum(prob, 1e-12))
    T = len(log_prob)
    value = np.full((T, N_CLASS), -np.inf)
    ptr = np.zeros((T, N_CLASS), np.int64)
    value[0] = log_prob[0] - np.log(N_CLASS)
    for t in range(1, T):
        trans_scores = value[t - 1][:, None] + log_trans
        ptr[t] = np.argmax(trans_scores, axis=0)
        value[t] = trans_scores[ptr[t], np.arange(N_CLASS)] + log_prob[t]
    path = np.zeros(T, np.int64)
    path[-1] = int(np.argmax(value[-1]))
    for t in range(T - 1, 0, -1):
        path[t - 1] = ptr[t, path[t]]
    return to_local_average_f0(hidden, center=path[:, None], thred=thred)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

class RMVPE:
    """16 kHz resampling, the centred HTK mel (host), 32-frame padding, the
    net on ``device`` (default CUDA), decoding, and the 10 ms curve resampled
    to the caller's hop.

    The net loads at its first use, not here, and a pickled runner leaves it
    behind: a ``spawn`` worker of the binarizer loads its own copy on the
    same device and never inherits a CUDA context."""

    def __init__(self, model_path, hop_length: int = 160, device=None):
        from ...ops.mel import MelConfig, MelSpectrogram

        self.model_path = model_path
        self.device = resolve_device(device)
        self.hop_length = hop_length
        self.model: Optional[E2E0] = None
        self.mel = MelSpectrogram(MelConfig(
            sample_rate=SAMPLE_RATE, n_mels=N_MELS, n_fft=WINDOW_LENGTH,
            win_size=WINDOW_LENGTH, hop_size=hop_length, fmin=MEL_FMIN, fmax=MEL_FMAX,
        ), htk=True, center=True)

    def __getstate__(self):
        return {**self.__dict__, "model": None}

    def load(self) -> E2E0:
        if self.model is None:
            ckpt = torch.load(self.model_path, map_location="cpu", weights_only=True)
            self.model = E2E0.from_state_dict(ckpt.get("model", ckpt)).to(self.device).eval()
        return self.model

    def mel_frames(self, audio: np.ndarray, sample_rate: int):
        """-> (the 16 kHz centred HTK mel padded to a multiple of 32 frames,
        [T', 128]; its frame count T before the padding)."""
        if sample_rate != SAMPLE_RATE:
            from scipy.signal import resample_poly

            g = np.gcd(SAMPLE_RATE, int(sample_rate))
            audio = resample_poly(audio, SAMPLE_RATE // g, sample_rate // g)
        mel = self.mel.numpy(np.asarray(audio, np.float32))
        n_frames = mel.shape[0]
        return np.pad(mel, [(0, 32 * ((n_frames - 1) // 32 + 1) - n_frames), (0, 0)]), n_frames

    @torch.no_grad()
    def salience(self, mel: np.ndarray) -> np.ndarray:
        """The net on ``device``: mel [T, 128] -> [T, 360]."""
        model = self.load()
        with exact_f32():
            x = torch.from_numpy(np.ascontiguousarray(mel.T[None])).to(self.device)
            return model(x)[0].cpu().numpy()

    def infer_from_audio(self, audio: np.ndarray, sample_rate: int = 16000,
                         thred: float = 0.03, use_viterbi: bool = False) -> np.ndarray:
        mel, n_frames = self.mel_frames(audio, sample_rate)
        hidden = self.salience(mel)[:n_frames]
        if use_viterbi:
            return to_viterbi_f0(hidden, thred=thred)
        return to_local_average_f0(hidden, thred=thred)

    def get_pitch(self, waveform, samplerate, length, *, hop_size, f0_min=65, f0_max=1100,
                  speed=1, interp_uv=False):
        from ...utils.curves import interp_f0, resample_align_curve

        f0 = self.infer_from_audio(waveform, sample_rate=samplerate)
        uv = f0 == 0
        f0, uv = interp_f0(f0, uv)
        time_step = int(np.round(hop_size * speed)) / samplerate
        f0_res = resample_align_curve(f0.astype(np.float32), 0.01, time_step, length)
        uv_res = resample_align_curve(uv.astype(np.float32), 0.01, time_step, length) > 0.5
        if not interp_uv:
            f0_res[uv_res] = 0
        return f0_res, uv_res
