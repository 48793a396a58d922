"""Multi-backend audio I/O (host-side, numpy).

Behavior spec: the reference convasr audio.py (read_audio audio.py:17-128,
write_audio audio.py:131-147, resample audio.py:150-159, compute_duration
audio.py:165-185, extract_meta audio.py:187-225).

Signals are numpy float32 arrays shaped (channels, time); int16 files are
scaled by 1/32767 like the reference (audio.py:13-15). Backends:
- 'scipy'     : in-process wav decode (fastest per README.md:220-233)
- 'soundfile' : optional, only if the module is installed
- 'sox'/'ffmpeg' : subprocess decode of arbitrary codecs with resample
- raw PCM     : .raw paths or raw_bytes (serving path, serve_google_api.py:29)

The native C++ wav reader of the JAX package is not carried over yet.
"""
import json
import os
import subprocess
import wave

import numpy as np
import scipy.io.wavfile
import scipy.signal

try:
    import soundfile
except ImportError:
    soundfile = None


AUDIO_FILE_EXTENSIONS = {'.mp3', '.m4a', '.amr', '.gsm', '.wav', '.mp4', '.opus', '.ogg', '.webm', '.3gp'}

SMAX = np.iinfo(np.int16).max


def f2s(signal: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16, CLIPPED. The reference's f2s_numpy
    (audio.py:14) casts without clipping, so |x| > 1 samples wrap to the
    opposite sign (e.g. +1.5 -> -0.5) and silently corrupt written audio —
    deliberate divergence: saturate like every codec does."""
    return np.multiply(np.clip(signal, -1.0, 1.0),
                       np.float32(SMAX)).astype('int16')


def s2f(signal: np.ndarray) -> np.ndarray:
    return np.divide(signal, np.float32(SMAX), dtype='float32')


_ULAW_LUT = None


def ulaw_to_int16(data: np.ndarray) -> np.ndarray:
    """ITU-T G.711 mu-law bytes -> int16 PCM via a 256-entry LUT.

    Telephony audio (the reference targets ru_open_stt phone calls,
    transcribe.py/serve_google_api.py 8 kHz defaults) arrives G.711-encoded;
    the google speech proto lists MULAW as a first-class encoding. Standard
    segmented expansion: byte -> complement -> sign/exponent/mantissa ->
    ((2*mantissa+33) << exponent) - 33, scaled x4 (max magnitude 32124).
    """
    global _ULAW_LUT
    if _ULAW_LUT is None:
        u = ~np.arange(256, dtype=np.uint8)
        exponent = (u >> 4) & 0x07
        mantissa = u & 0x0F
        magnitude = (((mantissa.astype(np.int32) << 3) + 0x84)
                     << exponent) - 0x84
        _ULAW_LUT = np.where(u & 0x80, -magnitude, magnitude).astype(np.int16)
    return _ULAW_LUT[np.frombuffer(data, dtype=np.uint8)
                     if isinstance(data, (bytes, bytearray)) else
                     np.asarray(data, dtype=np.uint8)]


def is_audio(audio_path: str) -> bool:
    return os.path.splitext(audio_path)[-1].lower() in AUDIO_FILE_EXTENSIONS


def _read_sox(audio_path, sample_rate, mono, raw_dtype, byte_order):
    num_channels = 1 if mono else int(subprocess.check_output(['soxi', '-V0', '-c', audio_path]))
    fmt = ['-b', '16', '-e', 'signed'] if raw_dtype == 'int16' else ['-b', '32', '-e', 'float']
    cmd = (['sox', '-V0', audio_path] + fmt +
           ['--endian', byte_order, '-r', str(sample_rate), '-c', str(num_channels), '-t', 'raw', '-'])
    data = subprocess.check_output(cmd)
    return sample_rate, np.frombuffer(data, dtype=raw_dtype).reshape(-1, num_channels)


def _read_ffmpeg(audio_path, sample_rate, mono, raw_dtype):
    num_channels = 1 if mono else int(subprocess.check_output([
        'ffprobe', '-i', audio_path, '-show_entries', 'stream=channels',
        '-select_streams', 'a:0', '-of', 'compact=p=0:nk=1', '-v', '0']))
    fmt = ['-f', 's16le'] if raw_dtype == 'int16' else ['-f', 'f32le']
    cmd = (['ffmpeg', '-i', audio_path, '-nostdin', '-hide_banner', '-nostats', '-loglevel', 'quiet']
           + fmt + ['-ar', str(sample_rate), '-ac', str(num_channels), '-'])
    data = subprocess.check_output(cmd)
    return sample_rate, np.frombuffer(data, dtype=raw_dtype).reshape(-1, num_channels)


def read_audio(audio_path, sample_rate, offset=0, duration=None, mono=True,
               raw_dtype='int16', dtype='float32', byte_order='little', backend=None,
               raw_bytes=None, raw_sample_rate=None, raw_num_channels=None):
    """Decode audio to (num_channels, T) at `sample_rate`; returns (signal, sample_rate)."""
    assert dtype in [None, 'int16', 'float32']
    assert backend in [None, 'scipy', 'soundfile', 'ffmpeg', 'sox']

    try:
        if audio_path is None or audio_path.endswith('.raw'):
            if audio_path is not None:
                with open(audio_path, 'rb') as f:
                    raw_bytes = f.read()
            sample_rate_ = raw_sample_rate
            if raw_dtype == 'mulaw':  # G.711 telephony bytes, one per sample
                signal = ulaw_to_int16(raw_bytes).reshape(-1, raw_num_channels or 1)
            else:
                signal = np.frombuffer(raw_bytes, dtype=raw_dtype).reshape(-1, raw_num_channels or 1)
        elif backend in ['scipy', None] and audio_path.endswith('.wav'):
            sample_rate_, signal = scipy.io.wavfile.read(audio_path)
            if signal.ndim == 1:
                signal = signal[:, None]
        elif backend == 'soundfile':
            assert soundfile is not None, 'soundfile backend requested but module not installed'
            signal, sample_rate_ = soundfile.read(audio_path, dtype=raw_dtype)
            if signal.ndim == 1:
                signal = signal[:, None]
        elif backend == 'sox':
            sample_rate_, signal = _read_sox(audio_path, sample_rate, mono, raw_dtype, byte_order)
        else:  # ffmpeg or fallback for non-wav
            sample_rate_, signal = _read_ffmpeg(audio_path, sample_rate, mono, raw_dtype)
    except Exception:
        # degrade to empty signal on decode errors (spec: audio.py:102-104)
        print(f'Error when reading [{audio_path}]')
        sample_rate_, signal = sample_rate, np.empty((0, 1), dtype=dtype or 'float32')

    if offset or duration is not None:
        begin = int(offset * sample_rate_) if offset else None
        end = int((offset + duration) * sample_rate_) if duration is not None else None
        signal = signal[slice(begin, end)]

    assert signal.dtype in [np.int16, np.float32]
    signal = np.ascontiguousarray(signal.T)

    if signal.dtype == np.int16 and dtype == 'float32':
        signal = s2f(signal)
    if mono and len(signal) > 1:
        assert signal.dtype == np.float32
        signal = signal.mean(0, keepdims=True)
    if sample_rate is not None and sample_rate_ != sample_rate:
        signal, sample_rate_ = resample(signal, sample_rate_, sample_rate)
    return signal, sample_rate_


def write_audio(audio_path, signal, sample_rate, mono=False, backend=None, format='wav'):
    signal = np.asarray(signal)
    if signal.ndim == 1:
        signal = signal[None, :]
    if mono and len(signal) > 1:
        signal = signal.mean(0, keepdims=True)
    if backend == 'scipy' or (backend is None and (not audio_path or audio_path.endswith('.wav'))):
        assert signal.dtype == np.float32
        scipy.io.wavfile.write(audio_path, sample_rate, f2s(signal.T))
        return audio_path
    elif backend == 'soundfile':
        assert soundfile is not None, 'soundfile backend requested but module not installed'
        subtype = 'FLOAT' if signal.dtype == np.float32 else 'PCM_16'
        soundfile.write(audio_path, signal.T, endian='LITTLE', samplerate=sample_rate,
                        subtype=subtype, format=format.upper())
        return audio_path
    raise ValueError(f'unsupported write backend {backend}')


def resample(signal: np.ndarray, sample_rate_: int, sample_rate: int):
    """Polyphase resampling (scipy.signal.resample_poly — same class of
    polyphase FIR filter librosa uses in the reference, audio.py:150-159)."""
    assert signal.dtype == np.float32
    gcd = np.gcd(sample_rate_, sample_rate)
    up, down = sample_rate // gcd, sample_rate_ // gcd
    out = scipy.signal.resample_poly(signal.astype(np.float64), up, down, axis=-1)
    return out.astype(np.float32), sample_rate


def compute_duration(audio_path, backend=None) -> float:
    assert backend in [None, 'scipy', 'ffmpeg', 'sox']
    if backend is None:
        backend = 'scipy' if audio_path.endswith('.wav') else 'ffmpeg'
    if backend == 'scipy':
        signal, sample_rate = read_audio(audio_path, sample_rate=None, dtype=None, mono=False, backend='scipy')
        return signal.shape[-1] / sample_rate
    elif backend == 'ffmpeg':
        cmd = ['ffprobe', '-v', 'error', '-show_entries', 'format=duration',
               '-of', 'default=noprint_wrappers=1:nokey=1', audio_path]
        return float(subprocess.check_output(cmd))
    else:
        return float(subprocess.check_output(['soxi', '-D', audio_path]))


def extract_meta(audio_path, backend=None) -> dict:
    """Return dict(num_channels, duration)."""
    assert backend in [None, 'ffmpeg', 'wave']
    if backend is None:
        backend = 'wave' if audio_path.endswith('.wav') else 'ffmpeg'
    if backend == 'wave':
        with wave.open(audio_path, 'r') as w:
            return dict(num_channels=w.getnchannels(), duration=w.getnframes() / w.getframerate())
    try:
        out = subprocess.check_output(['ffprobe', '-v', 'error', '-print_format', 'json',
                                       '-show_streams', audio_path])
        data = json.loads(out)
        return dict(num_channels=data['streams'][0]['channels'],
                    duration=float(data['streams'][0]['duration']))
    except Exception:
        return dict(num_channels=0, duration=0.0)
