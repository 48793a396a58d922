from .io import (
    read_audio, write_audio, resample, compute_duration, extract_meta, is_audio,
    f2s, s2f, AUDIO_FILE_EXTENSIONS, SMAX,
)
