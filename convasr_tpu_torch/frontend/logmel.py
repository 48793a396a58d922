"""Log-mel filterbank frontend in PyTorch (counterpart of
convasr_tpu/frontend/logmel.py).

signal normalize -> preemphasis 0.97 -> optional dither -> reflect+zero pad of
(freq_cutoff-1) -> STFT (hann, center=False) -> power spectrum -> mel
filterbank -> +eps -> log. As in the JAX package the STFT is one strided
convolution against a window-scaled real-DFT basis, and tensors are (B, T, C)
at the module boundary.

The float32 STFT conv must not run in TF32 on the card: TF32 keeps about three
decimal digits, and the log of the power spectrum turns that into large errors
in the quiet bins. `full_fp32()` switches cuDNN's TF32 off around it.
"""
import contextlib
import math
import typing

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(freq, htk: bool = False):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq / f_sp
    with np.errstate(divide='ignore'):
        log_mels = min_log_mel + np.log(np.maximum(freq, 1e-30) / min_log_hz) / logstep
    return np.where(freq >= min_log_hz, log_mels, mels)


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = f_sp * mels
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: typing.Optional[float] = None, htk: bool = False,
                   norm: str = 'slaney') -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft//2), the formula of
    librosa.filters.mel."""
    if fmax is None:
        fmax = sample_rate / 2
    fftfreqs = np.linspace(0, sample_rate / 2, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == 'slaney':
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def make_window(name: str, win_length: int, periodic: bool = True) -> np.ndarray:
    """Window by torch name; the formulas of torch.{hann,hamming,blackman,
    bartlett}_window."""
    n = max(win_length if periodic else win_length - 1, 1)
    t = 2.0 * np.pi * np.arange(win_length) / n
    name = name.replace('_window', '')
    if name == 'hann':
        w = 0.5 - 0.5 * np.cos(t)
    elif name == 'hamming':
        w = 0.54 - 0.46 * np.cos(t)
    elif name == 'blackman':
        w = 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2.0 * t)
    elif name == 'bartlett':
        x = np.arange(win_length) * 2.0 / n
        w = 1.0 - np.abs(x - 1.0)
    else:
        raise ValueError(f'unsupported window {name!r}; '
                         "use hann_window/hamming_window/blackman_window/bartlett_window")
    return w.astype(np.float32)


def stft_basis(n_fft: int, freq_cutoff: int, window: np.ndarray) -> np.ndarray:
    """Windowed real-DFT basis, shape (n_fft, 1, 2*freq_cutoff) as in the JAX
    package: column k is cos(2πkn/n_fft)·w(n), column freq_cutoff+k the -sin
    row; the window is zero-padded centered."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(freq_cutoff)[None, :]
    angle = 2.0 * np.pi * k * n / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    pad_left = (n_fft - len(window)) // 2
    padded_window = np.zeros(n_fft, dtype=np.float64)
    padded_window[pad_left:pad_left + len(window)] = window
    return (basis * padded_window[:, None]).astype(np.float32)[:, None, :]


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions in full float32 (cuDNN's TF32 off)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def compute_output_lengths(out_time: int, lengths_fraction: typing.Optional[torch.Tensor]):
    """ceil(float32(fraction) * T) as int32. The product is taken in float32,
    as in the JAX package: float64 moves olen at the edges."""
    if lengths_fraction is None:
        return torch.full((1,), out_time, dtype=torch.int32)
    assert lengths_fraction.is_floating_point(), \
        f'xlen dtype {lengths_fraction.dtype}: xlen is the valid FRACTION ' \
        f'of the padded time dim (float in (0, 1]), not absolute lengths'
    return torch.ceil(lengths_fraction.to(torch.float32) * out_time).to(torch.int32)


def temporal_mask(out_time: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T) boolean mask of valid frames."""
    return torch.arange(out_time, device=lengths.device)[None, :] < lengths[:, None]


class LogFilterBankFrontend(torch.nn.Module):
    """(B, T) signal -> (B, frames, n_mels) log-mel features. No parameters:
    the DFT basis and mel matrix are non-persistent buffers."""

    def __init__(self, out_channels: int, sample_rate: int, window_size: float,
                 window_stride: float, window: str = 'hann_window', dither: float = 1e-5,
                 dither0: float = 0.0, preemphasis: float = 0.97,
                 eps: float = float(np.finfo(np.float16).tiny),
                 normalize_signal_enabled: bool = True,
                 normalize_signal_multiplier: float = 1.0, window_periodic: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.sample_rate = sample_rate
        self.window_size = window_size
        self.window_stride = window_stride
        self.window = window
        self.dither = dither
        self.dither0 = dither0
        self.preemphasis = preemphasis
        self.eps = eps
        self.normalize_signal_enabled = normalize_signal_enabled
        self.normalize_signal_multiplier = normalize_signal_multiplier
        win = make_window(window, self.win_length, periodic=window_periodic)
        basis = stft_basis(self.nfft, self.freq_cutoff, win)            # (nfft, 1, 2fc)
        mel = mel_filterbank(sample_rate, self.nfft, out_channels,
                             fmin=0, fmax=int(sample_rate / 2)).T        # (fc, n_mels)
        self.register_buffer('basis', torch.from_numpy(basis.transpose(2, 1, 0).copy()),
                             persistent=False)                          # (2fc, 1, nfft)
        self.register_buffer('mel', torch.from_numpy(np.ascontiguousarray(mel)),
                             persistent=False)

    @property
    def win_length(self):
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self):
        return int(self.window_stride * self.sample_rate)

    @property
    def nfft(self):
        return 2 ** math.ceil(math.log2(self.win_length))

    @property
    def freq_cutoff(self):
        return self.nfft // 2 + 1

    def num_frames(self, signal_len: int) -> int:
        return (signal_len + 2 * (self.freq_cutoff - 1) - self.nfft) // self.hop_length + 1

    def forward(self, signal: torch.Tensor, mask: typing.Optional[torch.Tensor] = None,
                generator: typing.Optional[torch.Generator] = None) -> torch.Tensor:
        """signal: (B, T) float; mask: optional (B, T) valid-sample mask;
        generator: the source of dither noise (no dither without one)."""
        x = signal.to(torch.float32)
        if self.normalize_signal_enabled:
            peak = x.abs().amax(dim=-1, keepdim=True) + 1e-5
            x = x / (peak * self.normalize_signal_multiplier)
        if self.dither0 > 0 and generator is not None:
            x = x + self.dither0 * torch.randn(x.shape, generator=generator, device=x.device)
        if self.preemphasis > 0:
            x = torch.cat([x[:, :1], x[:, 1:] - self.preemphasis * x[:, :-1]], dim=-1)
        if self.dither > 0 and generator is not None:
            x = x + self.dither * torch.randn(x.shape, generator=generator, device=x.device)
        if mask is not None:
            x = x * mask.to(x.dtype)

        pad = self.freq_cutoff - 1
        x = x[:, None, :]
        # reflect-pad on the left, zero-pad on the right; reflection needs pad < T
        x = F.pad(x, (pad, 0), mode='reflect' if pad < x.shape[-1] else 'constant')
        x = F.pad(x, (0, pad))
        with full_fp32():
            spectrum = F.conv1d(x, self.basis, stride=self.hop_length)  # (B, 2fc, frames)
        spectrum = spectrum.transpose(1, 2)
        re, im = spectrum[..., :self.freq_cutoff], spectrum[..., self.freq_cutoff:]
        power = re * re + im * im
        return torch.log(power @ self.mel + self.eps)                   # (B, frames, n_mels)


def masked_instance_norm(x: torch.Tensor, mask: typing.Optional[torch.Tensor] = None,
                         eps: float = float(np.finfo(np.float16).tiny)) -> torch.Tensor:
    """Per-utterance, per-channel normalization over time of (B, T, C), in
    float32: biased variance with eps added before the sqrt (the legacy
    formula the JAX package keeps for WER parity). mask: optional (B, T)."""
    x32 = x.to(torch.float32)
    if mask is None:
        mean = x32.mean(dim=1, keepdim=True)
        centered = x32 - mean
        var = (centered * centered).mean(dim=1, keepdim=True)
        return (centered / torch.sqrt(var + eps)).to(x.dtype)
    m = mask.to(torch.float32)[:, :, None]
    count = m.sum(dim=1, keepdim=True)
    mean = (x32 * m).sum(dim=1, keepdim=True) / count
    centered = (x32 - mean) * m
    var = (centered * centered).sum(dim=1, keepdim=True) / count
    return (centered / torch.sqrt(var + eps)).to(x.dtype)
