"""Handcrafted acoustic features on the tensor's device — port of the
librosa half and the set dispatchers of ``mertools_tpu/ops/handcrafted.py``.

The reference computes MERBench's handcrafted baselines one clip at a time:
librosa for the mel spectrogram and MFCC (``MERBench/feature_extraction/
audio/handcrafted_feature_func.py:145-202``) and the openSMILE binary for
the IS09 / IS10 / IS13 / eGeMAPS sets (``:28-142``). Here a whole bucket of
clips runs as batched tensor math: framing, window, ``torch.fft.rfft``,
the mel and DCT products as fp32 matmuls. The JAX package's spectra are
``jnp.fft`` and its products einsums, outside any Pallas kernel, so no
hand-written kernel runs here.

Two behaviours depend on the batch, as in the JAX package, and are kept so
the port's stores equal its stores: :func:`power_to_db` clips at the
maximum of the whole batch minus ``top_db`` (librosa clips a clip alone),
and :func:`stft_power` reflect-pads at the end of the padded buffer, so the
last frames of a clip shorter than its bucket read zeros.

The openSMILE sets route to their chains: IS09 -> :mod:`.opensmile_is09`,
IS10 -> :mod:`.opensmile_is10`, IS13 -> :mod:`.opensmile_is13`, eGeMAPS ->
:mod:`.egemaps`. The LPC and line-spectral-pair helpers here serve IS10 and
IS13. The generic LLD bank and its functional grid (:func:`extract_lld_bank`,
:func:`apply_functional_grid`) are library components no set reaches, kept
so the module is the JAX one whole. The window, filterbank and DCT tables
are made in numpy as the JAX package makes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import on_device
from .fbank import frame_signal as _frames
from .mel import hertz_to_mel_slaney, mel_to_hertz_slaney

# the reference's own measured contract (handcrafted_feature_func.py:15-19)
FRAME_DIMS = {"IS09": 32, "IS10": 32, "IS13": 120, "eGeMAPS": 23}
UTT_DIMS = {"IS09": 384, "IS10": 1582, "IS13": 6372, "eGeMAPS": 88}


# ---------------------------------------------------------------------------
# framing / spectra
# ---------------------------------------------------------------------------


def n_frames_for(T: int, frame_len: int, hop: int) -> int:
    return max(1 + (T - frame_len) // hop, 1)


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, F, frame_len) with F = 1 + (T - frame_len)//hop (at
    least 1; an index past the end reads the last sample)."""
    return _frames(x, n_frames_for(x.shape[-1], frame_len, hop), frame_len, hop)


def frame_mask(lengths: torch.Tensor, n_frames: int, frame_len: int,
               hop: int) -> torch.Tensor:
    """(B,) sample lengths -> (B, F) bool mask of frames fully inside."""
    starts = torch.arange(n_frames, device=lengths.device) * hop
    return (starts[None, :] + frame_len) <= lengths.clamp_min(frame_len)[:, None]


def hann(n: int, periodic: bool = True) -> np.ndarray:
    m = n if periodic else n - 1
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / m)).astype(np.float32)


def centred_window(n_fft: int, win_length: int) -> np.ndarray:
    """A periodic Hann of ``win_length`` centred in ``n_fft`` zeros
    (librosa ``util.pad_center``)."""
    lpad = (n_fft - win_length) // 2
    w_full = np.zeros(n_fft, np.float32)
    w_full[lpad: lpad + win_length] = hann(win_length)
    return w_full


def reflect_index(T: int, pad: int) -> np.ndarray:
    """Indices of ``np.pad(x, pad, mode="reflect")`` along an axis of T
    (the reflection repeats where ``pad`` exceeds T - 1, as numpy's does)."""
    i = np.arange(-pad, T + pad)
    if T == 1:
        return np.zeros_like(i)
    period = 2 * (T - 1)
    i = np.abs(i) % period
    return np.where(i >= T, period - i, i)


def stft_power(x: torch.Tensor, n_fft: int, win_length: int, hop: int,
               center: bool = True) -> torch.Tensor:
    """librosa-style power spectrogram. (B, T) -> (B, F, n_fft//2+1).

    With ``center`` the buffer is reflect-padded by n_fft//2 at both ends,
    so frame f is centred at f*hop."""
    if center:
        idx = reflect_index(x.shape[-1], n_fft // 2)
        x = x[..., torch.from_numpy(idx).to(x.device)]
    frames = frame_signal(x, n_fft, hop) * on_device(centred_window, x.device, n_fft,
                                                      win_length)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def mel_filter_bank_librosa(sr: int, n_fft: int, n_mels: int,
                            fmin: float = 0.0, fmax: float | None = None
                            ) -> np.ndarray:
    """librosa-default (slaney scale, slaney norm) filterbank (n_mels, bins)."""
    fmax = fmax if fmax is not None else sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(hertz_to_mel_slaney(fmin), hertz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = mel_to_hertz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def power_to_db(S: torch.Tensor, amin: float = 1e-10,
                top_db: float | None = 80.0) -> torch.Tensor:
    """librosa.power_to_db with ref=1.0; the ``top_db`` floor is taken from
    the maximum of the whole batch, as the JAX package takes it."""
    log_spec = 10.0 * torch.log10(S.clamp_min(amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in), scipy/librosa norm='ortho'."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def delta_sg(x: torch.Tensor, width: int = 9, dim: int = 1) -> torch.Tensor:
    """librosa.feature.delta: Savitzky-Golay first derivative, window 9,
    edges replicated (librosa's mode='interp' differs only in the first and
    last width//2 frames)."""
    half = width // 2
    k = np.arange(-half, half + 1, dtype=np.float32)
    taps = (k / np.sum(k ** 2)).astype(np.float32)
    x_t = x.movedim(dim, -1)
    n = x_t.shape[-1]
    idx = np.clip(np.arange(-half, n + half), 0, n - 1)
    x_pad = x_t[..., torch.from_numpy(idx).to(x.device)]
    out = sum(float(taps[i]) * x_pad[..., i: i + n] for i in range(width))
    return out.movedim(-1, dim)


# ---------------------------------------------------------------------------
# librosa-equivalent features (handcrafted_feature_func.py:156-202)
# ---------------------------------------------------------------------------


def mel_spec_librosa(wav: torch.Tensor, sr: int = 22050,
                     frame_size: float = 0.025, frame_step: float = 0.010,
                     n_mels: int = 128, n_fft: int = 2048) -> torch.Tensor:
    """(B, T) -> (B, F, 128) linear-power mel spectrogram (log_mel=False in
    the reference, ``handcrafted_feature_func.py:167-182``)."""
    win = int(frame_size * sr)
    hop = int(frame_step * sr)
    S = stft_power(wav, n_fft, win, hop)
    return S @ on_device(mel_filter_bank_librosa, wav.device, sr, n_fft, n_mels).T


def mfcc_librosa(wav: torch.Tensor, sr: int = 22050, frame_size: float = 0.025,
                 frame_step: float = 0.010, n_mfcc: int = 40,
                 n_mels: int = 128, n_fft: int = 2048) -> torch.Tensor:
    """(B, T) -> (B, F, 120): MFCC-40 + delta + delta-delta (delta=True in
    the reference, ``handcrafted_feature_func.py:185-202``)."""
    S = mel_spec_librosa(wav, sr, frame_size, frame_step, n_mels, n_fft)
    mfcc = power_to_db(S) @ on_device(dct_matrix, wav.device, n_mfcc, n_mels).T
    d1 = delta_sg(mfcc, dim=1)
    d2 = delta_sg(d1, dim=1)
    return torch.cat([mfcc, d1, d2], dim=-1)


# ---------------------------------------------------------------------------
# low-level descriptors (the openSMILE LLD bank)
# ---------------------------------------------------------------------------

F0_MIN, F0_MAX = 55.0, 550.0


def _autocorr_fft(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return torch.fft.irfft(spec.real ** 2 + spec.imag ** 2, n=n_fft, dim=-1)


def _lpc_levinson(r: torch.Tensor, order: int) -> torch.Tensor:
    """Levinson-Durbin. r: (N, order+1) autocorrelation -> (N, order) LPC,
    with the JAX package's regularisers (1e-8 on the first error, 1e-10 a
    step; eGeMAPS's formant LPC keeps its own, ``egemaps._lpc_batched``)."""
    a = torch.zeros(r.shape[:-1] + (order + 1,), dtype=r.dtype, device=r.device)
    a[:, 0] = 1.0
    err = r[:, 0] + 1e-8
    idx = torch.arange(order + 1, device=r.device)
    for i in range(order):
        rev = (i + 1 - idx).clamp(0, order)
        m = ((idx >= 1) & (idx <= i)).to(r.dtype)
        # error-filter convention a = [1, -phi...]: the reflection
        # coefficient is k = (r[i+1] + sum_j a[j] r[i+1-j]) / err
        acc = torch.sum(a * r[:, rev] * m, dim=-1)
        k = (r[:, i + 1] + acc) / err
        # reflection update a_new[j] = a[j] - k * a[i+1-j]
        upd = ((idx >= 1) & (idx <= i + 1)).to(r.dtype)
        a = a - (k[:, None] * a[:, rev]) * upd
        err = err * (1.0 - k ** 2) + 1e-10
    return -a[:, 1:]


def _lsp_w(n_grid: int) -> np.ndarray:
    """The grid of :func:`_lsp_from_lpc`: n_grid points on [0, pi]."""
    return np.linspace(0.0, np.pi, n_grid).astype(np.float32)


def _lsp_basis(m: int, n_grid: int) -> np.ndarray:
    """cos(i w) on the grid for i = 0..m, (m+1, n_grid)."""
    return np.cos(_lsp_w(n_grid)[None, :] * np.arange(m + 1)[:, None]).astype(np.float32)


def _lsp_from_lpc(a: torch.Tensor, order: int, n_grid: int = 512) -> torch.Tensor:
    """Line spectral frequencies (N, order) in rad from LPC (N, order).

    P(z) = A(z) + z^-(p+1) A(z^-1) and Q(z) = A(z) - z^-(p+1) A(z^-1) are
    deflated by (1 + z^-1) and (1 - z^-1) to symmetric degree-p
    polynomials, whose unit-circle values reduce to the real functions
    G(w) = c_m + sum_i 2 c_{m-i} cos(iw); the LSPs are their sign changes
    on an ``n_grid`` cosine grid, placed by linear interpolation, then
    sorted (the JAX package's formulation)."""
    p = order
    assert p % 2 == 0, "even LPC order"
    m = p // 2
    ones = torch.ones_like(a[:, :1])
    zeros = torch.zeros_like(a[:, :1])
    a_full = torch.cat([ones, -a], dim=-1)                      # (N, p+1)
    af = torch.cat([a_full, zeros], dim=-1)                     # (N, p+2)
    ar = torch.cat([zeros, a_full.flip(-1)], dim=-1)

    def deflate(coeffs, sign):
        # divide by (1 + sign z^-1): b_k = c_k - sign * b_{k-1}
        b, out = torch.zeros_like(coeffs[:, 0]), []
        for k in range(p + 1):
            b = coeffs[:, k] - sign * b
            out.append(b)
        return torch.stack(out, dim=-1)

    w = on_device(_lsp_w, a.device, n_grid)
    basis = on_device(_lsp_basis, a.device, m, n_grid)
    step = float(np.diff(_lsp_w(n_grid)[:2])[0])

    def roots_of(c):
        gamma = torch.cat([c[:, m: m + 1], 2.0 * c[:, :m].flip(-1)], dim=-1)
        G = gamma @ basis                                       # (N, grid)
        flip = (torch.sign(G[:, 1:]) * torch.sign(G[:, :-1])) < 0
        den = G[:, 1:] - G[:, :-1]
        big = torch.abs(den) > 1e-12
        t = torch.where(big, -G[:, :-1] / torch.where(big, den, 1.0), 0.5)
        wr = w[:-1] + t.clamp(0.0, 1.0) * step
        cand = torch.where(flip, wr, np.pi * 2)
        return torch.sort(cand, dim=-1).values[:, :m]

    lsp = torch.sort(torch.cat([roots_of(deflate(af + ar, 1.0)),
                                roots_of(deflate(af - ar, -1.0))], dim=-1), dim=-1).values
    return lsp.clamp_max(np.pi)


def bank_freqs(sr: int, n_fft: int) -> np.ndarray:
    """The LLD bank's bin frequencies in Hz, (n_fft // 2 + 1,)."""
    return np.linspace(0, sr / 2, n_fft // 2 + 1).astype(np.float32)


def bank_band(sr: int, n_fft: int, lo: float, hi: float) -> np.ndarray:
    """1 on the LLD bank's bins in [lo, hi) Hz."""
    f = bank_freqs(sr, n_fft)
    return ((f >= lo) & (f < hi)).astype(np.float32)


def _spectral_stats(S: torch.Tensor, f: torch.Tensor) -> dict:
    """Per-frame spectral descriptors from a power spectrogram (B, F, K)
    with bin frequencies ``f`` (K,) on its device."""
    tot = torch.sum(S, dim=-1, keepdim=True) + 1e-10
    pnorm = S / tot
    centroid = torch.sum(pnorm * f, dim=-1)
    spread = torch.sqrt(torch.sum(pnorm * (f - centroid[..., None]) ** 2, dim=-1))
    entropy = -torch.sum(pnorm * torch.log(pnorm + 1e-10), dim=-1)
    flatness = torch.exp(torch.mean(torch.log(S + 1e-10), dim=-1)) / (
        torch.mean(S, dim=-1) + 1e-10)
    cum = torch.cumsum(pnorm, dim=-1)

    def rolloff(q):
        return f[torch.argmax((cum >= q).to(torch.uint8), dim=-1)]

    flux = torch.cat([torch.zeros_like(S[..., :1, 0]),
                      torch.sqrt(torch.sum((pnorm[..., 1:, :] - pnorm[..., :-1, :]) ** 2, dim=-1))],
                     dim=-1)
    # spectral slope via linear regression of log-power on freq
    logS = torch.log(S + 1e-10)
    fm = f - torch.mean(f)
    slope = torch.sum(logS * fm, dim=-1) / (torch.sum(fm ** 2) + 1e-10)
    return dict(centroid=centroid, spread=spread, entropy=entropy,
                flatness=flatness, flux=flux, slope=slope,
                rolloff25=rolloff(0.25), rolloff50=rolloff(0.50),
                rolloff75=rolloff(0.75), rolloff90=rolloff(0.90))


def _band_energy(S: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Log power of (B, F, K) in the band of the 0/1 bin mask ``m``."""
    return torch.log(torch.sum(S * m, dim=-1) + 1e-10)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., K) at idx (...,) along the last axis."""
    return torch.take_along_dim(x, idx[..., None].to(torch.int64), dim=-1)[..., 0]


def _shift1(x: torch.Tensor) -> torch.Tensor:
    """x one frame later along dim 1, its first frame repeated (the
    ``prepend=x[:, :1]`` of ``jnp.diff``)."""
    return torch.cat([x[:, :1], x[:, :-1]], dim=1)


def extract_lld_bank(wav: torch.Tensor, lengths: torch.Tensor, sr: int = 16000):
    """Compute the full LLD bank once; feature sets select columns.

    (B, T), (B,) -> (dict[name -> (B, F)], (B, F) frame mask); 25 ms
    frames, 10 ms hop (the openSMILE default) on the librosa-centred grid.
    The F0 envelope is a recursion over frames, one batched step a frame."""
    dev = wav.device
    wav = wav.to(torch.float32)
    win = int(0.025 * sr)
    hop = int(0.010 * sr)
    n_fft = 1024 if sr <= 16000 else 2048
    T = wav.shape[-1]
    nF = n_frames_for(T + 2 * (n_fft // 2), n_fft, hop)
    mask = frame_mask(lengths + 2 * (n_fft // 2), nF, n_fft, hop)

    padded = wav[..., on_device(reflect_index, dev, T, n_fft // 2)]
    frames_t = frame_signal(padded, n_fft, hop)
    windowed = frames_t * on_device(centred_window, dev, n_fft, win)
    spec = torch.fft.rfft(windowed, dim=-1)
    S = spec.real ** 2 + spec.imag ** 2                         # (B, F, K)
    K = S.shape[-1]
    fc = on_device(bank_freqs, dev, sr, n_fft)

    out = {}
    # -- energy / loudness
    ms = torch.mean(windowed ** 2, dim=-1)
    rms = torch.sqrt(ms + 1e-12)
    out["pcm_RMSenergy"] = rms
    out["pcm_LogEnergy"] = torch.log(ms + 1e-10)
    out["loudness"] = (torch.sum(S, dim=-1) + 1e-12) ** (1.0 / 3.0)  # Stevens-law proxy
    out["pcm_zcr"] = torch.mean(
        (torch.sign(frames_t[..., 1:]) != torch.sign(frames_t[..., :-1])).to(torch.float32),
        dim=-1)

    # -- F0 / voicing / HNR via linear (zero-padded) FFT autocorrelation over
    # the full 64 ms frame, unbiased, first qualifying peak
    ac = _autocorr_fft(frames_t, 2 * n_fft)
    lag_lo = int(sr / F0_MAX)
    lag_hi = min(int(sr / F0_MIN), n_fft - 1)
    lags = torch.arange(lag_lo, lag_hi, device=dev)
    unbias = n_fft / (n_fft - lags).to(torch.float32)
    acn = ac[..., lag_lo:lag_hi] * unbias / (ac[..., :1] + 1e-10)
    best_val = torch.amax(acn, dim=-1)
    no = torch.zeros_like(acn[..., :1], dtype=torch.bool)
    is_pk = torch.cat([no, (acn[..., 1:-1] > acn[..., :-2]) & (acn[..., 1:-1] >= acn[..., 2:]),
                       no], dim=-1)
    first = torch.argmax((is_pk & (acn >= 0.85 * best_val[..., None])).to(torch.uint8), dim=-1)
    # no qualifying peak (e.g. monotone ACF): fall back to the global max
    first = torch.where(_take(is_pk, first), first, torch.argmax(acn, dim=-1))
    voicing = torch.clamp(_take(acn, first), 0.0, 1.0)
    f0_raw = torch.div(acn.new_tensor(float(sr)), lags[first].to(torch.float32))
    voiced = voicing > 0.45
    f0 = torch.where(voiced, f0_raw, 0.0)
    out["F0final"] = f0
    out["voicingFinalUnclipped"] = voicing
    # exponential envelope of F0, a recursion over frames
    env = torch.empty_like(f0)
    e = torch.zeros_like(f0[:, 0])
    for t in range(f0.shape[1]):
        x = f0[:, t]
        e = torch.where(x > 0, 0.75 * e + 0.25 * x, e * 0.995)
        env[:, t] = e
    out["F0env"] = env
    out["logHNR"] = 10.0 * torch.log10(voicing.clamp(1e-4, 0.9999) /
                                       (1.0 - voicing).clamp_min(1e-4))

    # jitter / shimmer (frame-to-frame relative deviations, voiced only)
    dF0 = torch.abs(f0 - _shift1(f0))
    out["jitterLocal"] = torch.where(voiced, dF0 / (f0 + 1e-6), 0.0)
    ddF0 = torch.abs(dF0 - _shift1(dF0))
    out["jitterDDP"] = torch.where(voiced, ddF0 / (f0 + 1e-6), 0.0)
    dAmp = torch.abs(rms - _shift1(rms))
    out["shimmerLocal"] = dAmp / (rms + 1e-8)

    # -- spectral stats
    for k, v in _spectral_stats(S, fc).items():
        out[f"spectral_{k}"] = v

    def band(lo, hi):
        return _band_energy(S, on_device(bank_band, dev, sr, n_fft, lo, hi))

    out["alphaRatio"] = band(1000, 5000) - band(50, 1000)
    out["hammarbergIndex"] = band(0, 2000) - band(2000, 5000)
    out["slope0-500"] = band(250, 500) - band(0, 250)
    out["slope500-1500"] = band(1000, 1500) - band(500, 1000)
    # extra ComParE-style band/statistic LLDs
    out["band250-650"] = band(250, 650)
    out["band1000-4000"] = band(1000, 4000)
    pn = S / (torch.sum(S, dim=-1, keepdim=True) + 1e-10)
    mu = torch.sum(pn * fc, -1)
    sig = torch.sqrt(torch.sum(pn * (fc - mu[..., None]) ** 2, -1) + 1e-10)
    out["spectral_variance"] = sig ** 2
    out["spectral_skewness"] = torch.sum(pn * (fc - mu[..., None]) ** 3, -1) / (sig ** 3 + 1e-10)
    out["spectral_kurtosis"] = torch.sum(pn * (fc - mu[..., None]) ** 4, -1) / (sig ** 4 + 1e-10)
    out["psySharpness"] = out["spectral_centroid"] / 1000.0

    # -- MFCC 0-14 of 26 log mel bands, and 8 log mel bands
    logmel26 = torch.log(S @ on_device(mel_filter_bank_librosa, dev, sr, n_fft, 26, 20.0,
                                       sr / 2.0).T + 1e-10)
    mfcc15 = logmel26 @ on_device(dct_matrix, dev, 15, 26).T
    for i in range(15):
        out[f"mfcc{i}"] = mfcc15[..., i]
    logmel8 = torch.log(S @ on_device(mel_filter_bank_librosa, dev, sr, n_fft, 8, 20.0,
                                      6500.0).T + 1e-10)
    for i in range(8):
        out[f"logMelFreqBand{i}"] = logmel8[..., i]

    # -- LSP (order 8) from LPC of the windowed autocorrelation
    r = _autocorr_fft(windowed, n_fft)[..., : 8 + 1]
    B, F = r.shape[0], r.shape[1]
    lpc = _lpc_levinson(r.reshape(B * F, 9), 8)
    lsp = _lsp_from_lpc(lpc, 8).reshape(B, F, 8)
    for i in range(8):
        out[f"lspFreq{i}"] = lsp[..., i]

    # formants F1-F3: LSP pair midpoints as proxies
    lsp_hz = lsp * (sr / (2 * np.pi))
    for j, name in enumerate(["F1", "F2", "F3"]):
        lo, hi = lsp_hz[..., 2 * j], lsp_hz[..., 2 * j + 1]
        out[f"{name}frequency"] = (lo + hi) / 2.0
        out[f"{name}bandwidth"] = torch.abs(hi - lo)
        cbin = ((lo + hi) / 2.0 / (sr / 2.0) * (K - 1)).to(torch.int32).clamp(0, K - 1)
        out[f"{name}amplitude"] = torch.log(_take(S, cbin) + 1e-10)

    # harmonic ratios (eGeMAPS H1-H2, H1-A3 proxies)
    f0_bin = (f0 / (sr / 2.0) * (K - 1)).to(torch.int32).clamp(1, K // 2 - 1)
    h1 = torch.log(_take(S, f0_bin) + 1e-10)
    h2 = torch.log(_take(S, 2 * f0_bin) + 1e-10)
    out["logRelF0-H1-H2"] = h1 - h2
    out["logRelF0-H1-A3"] = h1 - out["F3amplitude"]
    return out, mask


# ---------------------------------------------------------------------------
# statistical functionals (masked, batched)
# ---------------------------------------------------------------------------


def _masked_moments(x, m, n):
    mean = torch.sum(x * m, 1) / n
    c = (x - mean[:, None, :]) * m
    var = torch.sum(c ** 2, 1) / n
    std = torch.sqrt(var + 1e-12)
    skew = torch.sum(c ** 3, 1) / n / (std ** 3 + 1e-12)
    kurt = torch.sum(c ** 4, 1) / n / (var ** 2 + 1e-12)
    return mean, std, skew, kurt


def _masked_percentile(x, mask, lengths, qs):
    """x (B,T,D), qs list -> (B, len(qs), D) via sort + gather (the sample
    at floor(q (n - 1)), no interpolation)."""
    s = torch.sort(torch.where(mask[:, :, None], x, torch.inf), dim=1).values
    outs = []
    for q in qs:
        idx = (q * (lengths - 1)).to(torch.int32).clamp(0, x.shape[1] - 1).to(torch.int64)
        outs.append(torch.take_along_dim(s, idx[:, None, None], dim=1)[:, 0])
    return torch.stack(outs, dim=1)


def apply_functional_grid(x: torch.Tensor, mask: torch.Tensor, names: tuple) -> torch.Tensor:
    """openSMILE functional grid over (B, T, D) masked frames.

    Returns (B, len(names)*D) ordered functional-major (func0 of all D, then
    func1, ...), mirroring openSMILE's CSV column order per LLD group.
    """
    B, T, D = x.shape
    mb = mask[:, :, None]
    m = mb.to(x.dtype)
    n = torch.sum(m, dim=1).clamp_min(1.0)
    lengths = n[:, 0]

    mean, std, skew, kurt = _masked_moments(x, m, n)
    neg_inf = torch.where(mb, x, -torch.inf)
    pos_inf = torch.where(mb, x, torch.inf)
    mx = torch.amax(neg_inf, dim=1)
    mn = torch.amin(pos_inf, dim=1)
    rng_ = mx - mn
    span = (lengths - 1).clamp_min(1.0)[:, None]
    argmx = torch.argmax(neg_inf, dim=1).to(x.dtype) / span
    argmn = torch.argmin(pos_inf, dim=1).to(x.dtype) / span

    # linear + quadratic regression on normalized time
    t = (torch.arange(T, dtype=x.dtype, device=x.device)[None, :, None] / span[:, :, None])
    tm = torch.sum(t * m, 1) / n
    tc = (t - tm[:, None, :]) * m
    xc = (x - mean[:, None, :]) * m
    stt = torch.sum(tc * tc, 1) + 1e-12
    slope = torch.sum(tc * xc, 1) / stt
    offset = mean - slope * tm
    resid = xc - slope[:, None, :] * tc
    lin_q = torch.sum(resid ** 2 * m, 1) / n
    lin_a = torch.sum(torch.abs(resid) * m, 1) / n
    # quadratic term via orthogonalized t^2
    t2 = tc * tc
    t2m = torch.sum(t2 * m, 1) / n
    t2c = (t2 - t2m[:, None, :]) * m
    s22 = torch.sum(t2c * t2c, 1) + 1e-12
    qcoef = torch.sum(t2c * resid, 1) / s22
    quad_resid = resid - qcoef[:, None, :] * t2c
    quad_q = torch.sum(quad_resid ** 2 * m, 1) / n

    pct = _masked_percentile(x, mask, lengths, [0.01, 0.25, 0.50, 0.75, 0.99, 0.20, 0.80])
    p1, q1, q2, q3, p99, p20, p80 = [pct[:, i] for i in range(7)]

    def uplevel(frac):
        thresh = mn + frac * rng_
        return torch.sum((x > thresh[:, None, :]) & mb, 1) / n

    dx = x - _shift1(x)
    rise = torch.sum((dx > 0).to(x.dtype) * m, 1) / n
    fall = torch.sum((dx < 0).to(x.dtype) * m, 1) / n
    mean_abs_d = torch.sum(torch.abs(dx) * m, 1) / n

    no = torch.zeros_like(x[:, :1], dtype=torch.bool)
    is_peak = torch.cat([no, (x[:, 1:-1] > x[:, :-2]) & (x[:, 1:-1] > x[:, 2:]), no], 1) & mb
    npeaks = torch.sum(is_peak.to(x.dtype), 1)
    peak_mean = torch.sum(torch.where(is_peak, x, 0.0), 1) / npeaks.clamp_min(1.0)
    pos, negv = (x > 0) & mb, (x < 0) & mb

    table = {
        "max": mx, "min": mn, "range": rng_, "maxPos": argmx, "minPos": argmn,
        "amean": mean, "stddev": std, "skewness": skew, "kurtosis": kurt,
        "linregc1": slope, "linregc2": offset, "linregerrA": lin_a,
        "linregerrQ": lin_q, "quadregc1": qcoef, "quadregerrQ": quad_q,
        "quartile1": q1, "quartile2": q2, "quartile3": q3,
        "iqr1-2": q2 - q1, "iqr2-3": q3 - q2, "iqr1-3": q3 - q1,
        "percentile1": p1, "percentile99": p99, "pctlrange0-1": p99 - p1,
        "percentile20": p20, "percentile80": p80, "pctlrange20-80": p80 - p20,
        "upleveltime25": uplevel(0.25), "upleveltime50": uplevel(0.50),
        "upleveltime75": uplevel(0.75), "upleveltime90": uplevel(0.90),
        "risetime": rise, "falltime": fall, "meanAbsDelta": mean_abs_d,
        "peakMean": peak_mean, "peakRate": npeaks / n,
        "peakMeanRel": peak_mean - mean,
        "rqmean": torch.sqrt(torch.sum(x ** 2 * m, 1) / n),
        "absMean": torch.sum(torch.abs(x) * m, 1) / n,
        "posMean": (torch.sum(torch.where(x > 0, x, 0.0) * m, 1)
                    / torch.sum(pos.to(x.dtype), 1).clamp_min(1.0)),
        "negMean": (torch.sum(torch.where(x < 0, x, 0.0) * m, 1)
                    / torch.sum(negv.to(x.dtype), 1).clamp_min(1.0)),
        "tCentroid": (torch.sum(t * torch.abs(x) * m, 1)
                      / (torch.sum(torch.abs(x) * m, 1) + 1e-10)),
    }
    return torch.cat([table[f] for f in names], dim=-1)


FUNCTIONALS_IS09 = ("max", "min", "range", "maxPos", "minPos", "amean",
                    "linregc1", "linregc2", "linregerrQ", "stddev",
                    "skewness", "kurtosis")  # 12: the actual IS09 list

FUNCTIONALS_21 = ("maxPos", "minPos", "amean", "linregc1", "linregc2",
                  "linregerrA", "linregerrQ", "stddev", "skewness", "kurtosis",
                  "quartile1", "quartile2", "quartile3", "iqr1-2", "iqr2-3",
                  "iqr1-3", "percentile1", "percentile99", "pctlrange0-1",
                  "upleveltime75", "upleveltime90")  # 21: IS10 grid

FUNCTIONALS_19 = FUNCTIONALS_21[2:]  # pitch-group grid (IS10: 19)

FUNCTIONALS_EXTRA11 = ("upleveltime25", "upleveltime50", "risetime",
                       "falltime", "meanAbsDelta", "peakMean", "peakRate",
                       "peakMeanRel", "rqmean", "absMean", "tCentroid")

FUNCTIONALS_42 = tuple(dict.fromkeys(
    FUNCTIONALS_21 + FUNCTIONALS_IS09 +
    ("quadregc1", "quadregerrQ", "percentile20", "percentile80",
     "pctlrange20-80", "upleveltime25", "upleveltime50", "risetime",
     "falltime", "meanAbsDelta", "peakMean", "peakRate", "peakMeanRel",
     "rqmean", "absMean", "posMean", "negMean", "tCentroid")))
assert len(FUNCTIONALS_42) == 42, len(FUNCTIONALS_42)


# LLD column selections -----------------------------------------------------

LLD_IS09 = ("pcm_zcr", "pcm_RMSenergy", "F0final", "logHNR") + tuple(
    f"mfcc{i}" for i in range(1, 13))                      # 16
LLD_IS10 = (("loudness",) + tuple(f"mfcc{i}" for i in range(15)) +
            tuple(f"logMelFreqBand{i}" for i in range(8)) +
            tuple(f"lspFreq{i}" for i in range(8)) +
            ("F0env", "voicingFinalUnclipped"))            # 34
LLD_IS10_PITCH = ("F0final", "jitterLocal", "jitterDDP", "shimmerLocal")  # 4
LLD_IS13 = (LLD_IS10 + LLD_IS10_PITCH +
            ("pcm_zcr", "pcm_RMSenergy", "logHNR",
             "spectral_centroid", "spectral_spread", "spectral_entropy",
             "spectral_flatness", "spectral_flux", "spectral_slope",
             "spectral_rolloff25", "spectral_rolloff50", "spectral_rolloff75",
             "spectral_rolloff90", "alphaRatio", "hammarbergIndex",
             "pcm_LogEnergy", "band250-650", "band1000-4000",
             "spectral_variance", "spectral_skewness", "spectral_kurtosis",
             "psySharpness"))                              # 60
LLD_EGEMAPS = ("loudness", "alphaRatio", "hammarbergIndex", "slope0-500",
               "slope500-1500", "spectral_flux", "mfcc1", "mfcc2", "mfcc3",
               "mfcc4", "F0final", "jitterLocal", "shimmerLocal", "logHNR",
               "logRelF0-H1-H2", "logRelF0-H1-A3", "F1frequency",
               "F1bandwidth", "F1amplitude", "F2frequency", "F2amplitude",
               "F3frequency", "F3amplitude")               # 23 (eGeMAPS LLDs)


def _stack(llds: dict, names) -> torch.Tensor:
    return torch.stack([llds[n] for n in names], dim=-1)


def _egemaps_88(llds: dict, mask: torch.Tensor) -> torch.Tensor:
    """88-dim eGeMAPS-style summary of the LLD bank (18 LLD mean + cv = 36,
    pitch/loudness percentiles and slopes = 16, spectral means = 26,
    unvoiced stats = 4, temporal = 6). No set reaches it; the eGeMAPS
    chain is :mod:`.egemaps`."""
    m18 = ("loudness", "alphaRatio", "hammarbergIndex", "slope0-500",
           "slope500-1500", "spectral_flux", "mfcc1", "mfcc2", "mfcc3",
           "mfcc4", "F0final", "jitterLocal", "shimmerLocal", "logHNR",
           "logRelF0-H1-H2", "logRelF0-H1-A3", "F1frequency", "F2frequency")
    mean_cv = apply_functional_grid(_stack(llds, m18), mask, ("amean", "stddev"))
    mean = mean_cv[:, :18]
    cv = mean_cv[:, 18:] / (torch.abs(mean) + 1e-6)           # 36

    extra = apply_functional_grid(
        _stack(llds, ("F0final", "loudness")), mask,
        ("percentile20", "quartile2", "percentile80", "pctlrange20-80", "risetime",
         "falltime", "linregc1", "meanAbsDelta"))            # 16

    spec = _stack(llds, ("F1bandwidth", "F1amplitude", "F2amplitude",
                         "F3frequency", "F3amplitude", "spectral_centroid",
                         "spectral_entropy", "spectral_flatness",
                         "spectral_rolloff25", "spectral_rolloff50",
                         "spectral_rolloff75", "spectral_rolloff90",
                         "spectral_spread"))
    spec_f = apply_functional_grid(spec, mask, ("amean", "stddev"))  # 26

    f32 = torch.float32
    voiced = (llds["F0final"] > 0) & mask
    n = torch.sum(mask.to(f32), 1).clamp_min(1.0)
    nv = torch.sum(voiced.to(f32), 1)
    unvoiced = (~voiced) & mask
    n_useg = torch.sum((unvoiced[:, 1:] & ~unvoiced[:, :-1]).to(f32), 1) + unvoiced[:, 0]
    mean_useg_len = torch.sum(unvoiced.to(f32), 1) / n_useg.clamp_min(1.0)
    loud = llds["loudness"]
    n_u = torch.sum(unvoiced.to(f32), 1).clamp_min(1.0)
    lm = torch.sum(loud * unvoiced, 1) / n_u
    lsd = torch.sqrt(torch.sum(((loud - lm[:, None]) * unvoiced) ** 2, 1) / n_u + 1e-12)
    unvoiced_stats = torch.stack([nv / n, n_useg / n, mean_useg_len * 0.010, lm], -1)  # 4

    n_vseg = torch.sum((voiced[:, 1:] & ~voiced[:, :-1]).to(f32), 1) + voiced[:, 0]
    mean_vseg = torch.sum(voiced.to(f32), 1) / n_vseg.clamp_min(1.0)
    no = torch.zeros_like(mask[:, :1])
    is_peak = torch.cat([no, (loud[:, 1:-1] > loud[:, :-2]) & (loud[:, 1:-1] > loud[:, 2:]),
                         no], 1) & mask
    npk = torch.sum(is_peak.to(f32), 1)
    temporal = torch.stack([n_vseg / n, mean_vseg * 0.010, npk / (n * 0.010),
                            lsd, nv * 0.010, n * 0.010], -1)  # 6
    return torch.cat([mean, cv, extra, spec_f, unvoiced_stats, temporal], -1)


# ---------------------------------------------------------------------------
# the openSMILE set dispatchers
# ---------------------------------------------------------------------------

_CHAINS = {"IS09": ("opensmile_is09", "is09"), "IS10": ("opensmile_is10", "is10"),
           "IS13": ("opensmile_is13", "is13"), "eGeMAPS": ("egemaps", "egemaps")}


def _chain(feature_set: str, sr: int, level: str):
    """The set's ``{prefix}_{level}`` function, its chain imported on
    first use."""
    import importlib

    if feature_set not in _CHAINS:
        raise ValueError(feature_set)
    module, prefix = _CHAINS[feature_set]
    mod = importlib.import_module(f".{module}", __package__)
    if sr != mod.SR:
        raise ValueError(f"the {feature_set} chain is defined at {mod.SR} Hz, got {sr}")
    return getattr(mod, f"{prefix}_{level}")


def handcrafted_frame(wav: torch.Tensor, lengths: torch.Tensor, sr: int = 16000,
                      feature_set: str = "IS09"):
    """Frame-level (LLD) features: (B, T) -> ((B, F, FRAME_DIMS[set]), (B, F)
    mask)."""
    return _chain(feature_set, sr, "frame")(wav, lengths)


def handcrafted_utt(wav: torch.Tensor, lengths: torch.Tensor, sr: int = 16000,
                    feature_set: str = "IS09") -> torch.Tensor:
    """Utterance-level functionals: (B, T) -> (B, UTT_DIMS[set])."""
    return _chain(feature_set, sr, "utt")(wav, lengths)


def handcrafted_levels(wav: torch.Tensor, lengths: torch.Tensor, sr: int = 16000,
                       feature_set: str = "IS09"):
    """Both levels from one contour pass: (:func:`handcrafted_utt`, then
    :func:`handcrafted_frame`'s frames and mask), each as those give it."""
    return _chain(feature_set, sr, "levels")(wav, lengths)
