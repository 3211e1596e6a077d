"""VGGish (AudioSet) and fairseq wav2vec 1.0 in PyTorch — port of
``mertools_tpu/encoders/audio_zoo.py``.

- VGGish gives a 128-d embedding a 0.96 s log-mel patch
  (``MERBench/feature_extraction/audio/extract_vggish_embedding.py:16-17``):
  the frontend (96 x 64 log-mel patches, Google's parameters) and the VGG
  conv stack. The module carries torchvggish's key names
  (``features.{0,3,6,8,11,13}``, ``embeddings.{0,2,4}``), so a torchvggish
  state dict loads with ``load_state_dict``.
- wav2vec 1.0 gives "z" (conv feature encoder) and "c" (context network)
  features (``MER2023/feature_extraction/audio/
  extract_wav2vec_embedding.py:14,30-52``), both returned. The module
  carries the key names of the JAX package's converter
  (``feature_extractor.conv_layers.{i}.{0,2}``,
  ``feature_aggregator.conv_layers.{i}.{0,2}``) and its semantics: nine
  context layers of kernel 3, symmetric ``k // 2`` zero padding, no skip
  connections (ROADMAP §C lists where this departs from fairseq's
  ``wav2vec_large``).

Public layouts follow the JAX package: wav (B, T), features (B, T', C);
the convs run in NCHW / NCW.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fbank import frame_signal
from ..core.flax_init import init_flax_style

# ---------------------------------------------------------------------------
# VGGish frontend: Google params (vggish_params.py of the public release)
# ---------------------------------------------------------------------------
VGGISH_SR = 16000
_WIN = int(0.025 * VGGISH_SR)     # 400
_HOP = int(0.010 * VGGISH_SR)     # 160
_N_MELS = 64
_PATCH_FRAMES = 96                # 0.96 s patches
_LOG_OFFSET = 0.01
_FMIN, _FMAX = 125.0, 7500.0
_N_FFT = 512


def _hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def vggish_mel_matrix(n_fft: int = _N_FFT) -> np.ndarray:
    """HTK-scale triangular filterbank, Google slaney-free variant
    (vggish/mel_features.py spectrogram_to_mel_matrix): (bins, 64)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, VGGISH_SR / 2.0, n_bins)
    mel_edges = np.linspace(_hz_to_mel_htk(_FMIN), _hz_to_mel_htk(_FMAX),
                            _N_MELS + 2)
    mel_freqs = _hz_to_mel_htk(fft_freqs)
    weights = np.zeros((n_bins, _N_MELS))
    for i in range(_N_MELS):
        lo, ctr, hi = mel_edges[i: i + 3]
        lower = (mel_freqs - lo) / (ctr - lo)
        upper = (hi - mel_freqs) / (hi - ctr)
        weights[:, i] = np.maximum(0.0, np.minimum(lower, upper))
    weights[0] = 0.0
    return weights.astype(np.float32)


def vggish_frames(n_samples: int) -> int:
    """STFT frames of a clip of ``n_samples`` (at least one)."""
    return max(1 + (n_samples - _WIN) // _HOP, 1)


def vggish_patches(n_samples: int) -> int:
    """0.96 s patches a clip of ``n_samples`` keeps (at least one)."""
    return max(vggish_frames(n_samples) // _PATCH_FRAMES, 1)


@functools.lru_cache(maxsize=None)
def _vggish_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(periodic Hann window (400,), mel matrix (257, 64)) on ``device``,
    uploaded once; callers only read them."""
    return (torch.from_numpy(np.hanning(_WIN + 1)[:-1].astype(np.float32)).to(device),
            torch.from_numpy(vggish_mel_matrix()).to(device))


def vggish_log_mel_patches(wav: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz float -> (B, P, 96, 64) log-mel patches: periodic Hann
    window 25 ms / 10 ms hop, |STFT| magnitude at n 512 (not power, as
    mel_features.py), HTK mel 125-7500 Hz, log(mel + 0.01), non-overlapping
    96-frame patches; a clip shorter than one patch is zero-padded to one."""
    B, T = wav.shape
    window, mel = _vggish_tables(wav.device)
    n_frames = vggish_frames(T)
    frames = frame_signal(wav, n_frames, _WIN, _HOP) * window
    spec = torch.fft.rfft(frames, n=_N_FFT, dim=-1).abs()
    logmel = torch.log(spec @ mel + _LOG_OFFSET)
    P = vggish_patches(T)
    logmel = logmel[:, : P * _PATCH_FRAMES]
    if n_frames < _PATCH_FRAMES:
        logmel = F.pad(logmel, (0, 0, 0, _PATCH_FRAMES - n_frames))
    return logmel.reshape(B, P, _PATCH_FRAMES, _N_MELS)


class VGGish(nn.Module):
    """(B, 96, 64) log-mel patch -> (B, 128) embedding (VGG conv stack + 3
    FC layers, torchvggish layer order and key names)."""

    def __init__(self):
        super().__init__()
        conv = lambda i, o: nn.Conv2d(i, o, 3, padding=1)
        self.features = nn.Sequential(
            conv(1, 64), nn.ReLU(), nn.MaxPool2d(2),
            conv(64, 128), nn.ReLU(), nn.MaxPool2d(2),
            conv(128, 256), nn.ReLU(), conv(256, 256), nn.ReLU(), nn.MaxPool2d(2),
            conv(256, 512), nn.ReLU(), conv(512, 512), nn.ReLU(), nn.MaxPool2d(2))
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 24, 4096), nn.ReLU(), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, 128), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x[:, None])                     # (B, 512, 6, 4)
        # torchvggish permutes NCHW -> NHWC before flattening, the JAX
        # package's native layout
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.embeddings(x)


def vggish_extract(model: VGGish, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, P, 128) per-patch embeddings."""
    patches = vggish_log_mel_patches(wav)
    B, P = patches.shape[:2]
    emb = model(patches.reshape(B * P, _PATCH_FRAMES, _N_MELS))
    return emb.reshape(B, P, -1)


_VGGISH_CONVS = {"conv1": 0, "conv2": 3, "conv3_1": 6, "conv3_2": 8,
                 "conv4_1": 11, "conv4_2": 13}
_VGGISH_FCS = {"fc1_1": 0, "fc1_2": 2, "fc2": 4}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def vggish_state_dict_from_flax(params) -> dict:
    """The JAX package's VGGish param tree -> torchvggish key names; the
    inverse of ``vggish_from_torch`` (``audio_zoo.py:114-133``)."""
    sd = {}
    for name, i in _VGGISH_CONVS.items():
        sd[f"features.{i}.weight"] = _t(np.asarray(params[name]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"features.{i}.bias"] = _t(params[name]["bias"])
    for name, i in _VGGISH_FCS.items():
        sd[f"embeddings.{i}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
        sd[f"embeddings.{i}.bias"] = _t(params[name]["bias"])
    return sd


def vggish_init_params(generator: torch.Generator) -> dict:
    """Seeded weights with Flax's default initialisers, as the JAX CLI's
    ``--random_init`` draws VGGish."""
    with torch.device("meta"):
        model = VGGish()
    return init_flax_style(model.to_empty(device=generator.device), generator).state_dict()


# ---------------------------------------------------------------------------
# wav2vec 1.0 (fairseq)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Wav2Vec1Config:
    # feature encoder (z): (dim, kernel, stride) per layer
    enc_layers: tuple = ((512, 10, 5), (512, 8, 4), (512, 4, 2),
                         (512, 4, 2), (512, 4, 2))
    # context network (c): kernel per layer (stride 1)
    ctx_layers: tuple = ((512, 3), (512, 3), (512, 3), (512, 3), (512, 3),
                         (512, 3), (512, 3), (512, 3), (512, 3))
    log_compression: bool = True


def _next_valid(n: torch.Tensor, k: int, s: int) -> torch.Tensor:
    return torch.clamp_min(torch.div(n - k, s, rounding_mode="floor") + 1, 1)


class _W2V1Block(nn.Sequential):
    """fairseq's ``Sequential(conv, dropout, norm, relu)``; the norm is an
    instance norm over time (``Fp32GroupNorm(C, C)``). With ``n_valid`` the
    statistics span the valid frames only and the pad lanes are zeroed after
    the affine and ReLU, so the next conv's boundary frames read what conv
    zero-padding gives an unpadded clip."""

    def __init__(self, c_in: int, dim: int, kernel: int, stride: int = 1, pad: int = 0):
        super().__init__(nn.Conv1d(c_in, dim, kernel, stride=stride, padding=pad),
                         nn.Identity(), nn.GroupNorm(dim, dim))

    def forward(self, x: torch.Tensor, n_valid: torch.Tensor | None = None):
        x = self[0](x)                                     # (B, C, T)
        if n_valid is None:
            m = None
            mean = x.mean(dim=2, keepdim=True)
            var = (x - mean).square().mean(dim=2, keepdim=True)
        else:
            m = (torch.arange(x.shape[2], device=x.device)[None, None, :]
                 < n_valid[:, None, None]).to(x.dtype)
            cnt = torch.clamp_min(n_valid.to(x.dtype), 1.0)[:, None, None]
            mean = (x * m).sum(dim=2, keepdim=True) / cnt
            var = ((x - mean) * m).square().sum(dim=2, keepdim=True) / cnt
        norm = self[2]
        x = (x - mean) * torch.rsqrt(var + 1e-5)
        x = torch.relu(x * norm.weight[:, None] + norm.bias[:, None])
        return x if m is None else x * m


class Wav2Vec1(nn.Module):
    """(B, T) wav -> dict(z=(B, Tz, C), c=(B, Tz, C)). ``lengths`` enables
    right-padded batching: per-layer valid frame counts drive the masked
    instance norms, so rows [0, z_len_i) match unpadded per-clip execution;
    :func:`w2v1_out_lengths` gives the counts to trim to."""

    def __init__(self, cfg: Wav2Vec1Config = Wav2Vec1Config()):
        super().__init__()
        self.cfg = cfg
        enc, c_in = [], 1
        for dim, k, s in cfg.enc_layers:
            enc.append(_W2V1Block(c_in, dim, k, s))
            c_in = dim
        ctx = []
        for dim, k in cfg.ctx_layers:
            # pad k // 2, stride 1: the time scale (and valid count) is
            # unchanged, and frames at the valid/pad boundary read zeroed
            # pad lanes as unpadded edges read conv padding
            ctx.append(_W2V1Block(c_in, dim, k, 1, pad=k // 2))
            c_in = dim
        self.feature_extractor = nn.Module()
        self.feature_extractor.conv_layers = nn.ModuleList(enc)
        self.feature_aggregator = nn.Module()
        self.feature_aggregator.conv_layers = nn.ModuleList(ctx)

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor | None = None) -> dict:
        x, n = wav[:, None], lengths
        for (_, k, s), block in zip(self.cfg.enc_layers,
                                    self.feature_extractor.conv_layers):
            if n is not None:
                n = _next_valid(n, k, s)
            x = block(x, n)
        if self.cfg.log_compression:
            x = torch.log(1.0 + x.abs())
        z = x
        for block in self.feature_aggregator.conv_layers:
            x = block(x, n)
        return {"z": z.transpose(1, 2), "c": x.transpose(1, 2)}


def w2v1_out_lengths(n: np.ndarray, cfg: Wav2Vec1Config | None = None) -> np.ndarray:
    """Input sample counts -> z/c frame counts (valid-conv shrinkage)."""
    cfg = cfg or Wav2Vec1Config()
    n = np.asarray(n)
    for _, k, s in cfg.enc_layers:
        n = np.maximum((n - k) // s + 1, 1)
    return n


def wav2vec1_state_dict_from_flax(params, cfg: Wav2Vec1Config | None = None) -> dict:
    """The JAX package's Wav2Vec1 param tree -> this module's state dict;
    the inverse of ``wav2vec1_from_fairseq`` (``audio_zoo.py:244-260``)."""
    cfg = cfg or Wav2Vec1Config()
    sd = {}

    def block(prefix, p):
        sd[f"{prefix}.0.weight"] = _t(np.asarray(p["conv"]["kernel"]).transpose(2, 1, 0))
        sd[f"{prefix}.0.bias"] = _t(p["conv"]["bias"])
        sd[f"{prefix}.2.weight"] = _t(p["norm_scale"])
        sd[f"{prefix}.2.bias"] = _t(p["norm_bias"])

    for i in range(len(cfg.enc_layers)):
        block(f"feature_extractor.conv_layers.{i}", params[f"enc_{i}"])
    for i in range(len(cfg.ctx_layers)):
        block(f"feature_aggregator.conv_layers.{i}", params[f"ctx_{i}"])
    return sd


def wav2vec1_init_params(cfg: Wav2Vec1Config, generator: torch.Generator) -> dict:
    """Seeded weights with Flax's default initialisers, as the JAX CLI's
    ``--random_init`` draws wav2vec 1.0."""
    with torch.device("meta"):
        model = Wav2Vec1(cfg)
    return init_flax_style(model.to_empty(device=generator.device), generator).state_dict()

