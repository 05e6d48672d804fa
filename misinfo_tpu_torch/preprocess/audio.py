"""Audio frontend: ffmpeg PCM decode + log-mel spectrogram for Whisper.

Host copy of ``misinfo_tpu/preprocess/audio.py``, importable without JAX;
held to the original by tests/test_torch_host.py. numpy only: ffmpeg is
looked up when a file is decoded, and a PCM WAV decodes with the stdlib
reader when no ffmpeg exists.

Replicates the reference's transcript audio path (C13, reference
forensics_dashboard.py:54-74): ffmpeg decodes the video's audio track to
16 kHz mono s16le PCM; the log-mel computation follows Whisper's recipe
(n_fft 400, hop 160, 80 mels, log10 clamp + dynamic-range compression).
"""

from __future__ import annotations

import functools
import subprocess
from typing import Optional

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80


def ffmpeg_decode_audio(path: str, sample_rate: int = SAMPLE_RATE
                        ) -> Optional[np.ndarray]:
    """Decode a media file's audio to float32 mono PCM via ffmpeg
    (imageio-ffmpeg's bundled binary, falling back to a system ffmpeg).
    Returns None when no decoder is available — soft-fail contract
    (reference forensics_dashboard.py:32-44)."""
    try:
        import imageio_ffmpeg
        exe = imageio_ffmpeg.get_ffmpeg_exe()
    except Exception:
        import shutil
        exe = shutil.which("ffmpeg")
    if not exe:
        return None
    cmd = [exe, "-nostdin", "-i", path, "-f", "s16le", "-acodec", "pcm_s16le",
           "-ac", "1", "-ar", str(sample_rate), "-"]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except Exception:
        return None
    if not out:
        return None
    return np.frombuffer(out, np.int16).astype(np.float32) / 32768.0


def _read_wav(path: str, sample_rate: int = SAMPLE_RATE
              ) -> Optional[np.ndarray]:
    """Stdlib WAV reader (PCM 8/16/32-bit) with linear resampling to the
    target rate."""
    import wave

    try:
        with wave.open(path, "rb") as w:
            n_ch, width, sr = w.getnchannels(), w.getsampwidth(), w.getframerate()
            raw = w.readframes(w.getnframes())
    except Exception:
        return None
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}.get(width)
    if dtype is None or not raw:
        return None
    pcm = np.frombuffer(raw, dtype).astype(np.float32)
    if width == 1:
        pcm = (pcm - 128.0) / 128.0
    else:
        pcm = pcm / float(2 ** (8 * width - 1))
    if n_ch > 1:
        pcm = pcm.reshape(-1, n_ch).mean(axis=1)
    if sr != sample_rate and len(pcm):
        t_out = np.arange(int(round(len(pcm) * sample_rate / sr)))
        pcm = np.interp(t_out * (sr / sample_rate),
                        np.arange(len(pcm)), pcm).astype(np.float32)
    return pcm


def decode_audio(path: str, sample_rate: int = SAMPLE_RATE
                 ) -> Optional[np.ndarray]:
    """Audio decode cascade: ffmpeg (any container) → stdlib WAV reader.
    None when neither can decode — callers soft-fail to an empty
    transcript."""
    audio = ffmpeg_decode_audio(path, sample_rate)
    if audio is None and path.lower().endswith(".wav"):
        audio = _read_wav(path, sample_rate)
    return audio


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=4)
def _mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-style mel filterbank (librosa default, as Whisper uses)."""
    fmin, fmax = 0.0, sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        mel = np.where(log_region,
                       15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                       mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
        return f

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(freqs)
    ramps = freqs[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (freqs[2:n_mels + 2] - freqs[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = N_MELS,
                        n_fft: int = N_FFT, hop: int = HOP_LENGTH,
                        sr: int = SAMPLE_RATE) -> np.ndarray:
    """float32 PCM → [T, n_mels] log-mel features (Whisper recipe)."""
    audio = np.pad(audio, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(audio) - n_fft) // hop
    window = _hann(n_fft)
    frames = np.lib.stride_tricks.as_strided(
        audio, shape=(n_frames, n_fft),
        strides=(audio.strides[0] * hop, audio.strides[0])).copy()
    spec = np.abs(np.fft.rfft(frames * window, axis=1)) ** 2
    mel = spec @ _mel_filterbank(sr, n_fft, n_mels).T
    log_mel = np.log10(np.maximum(mel, 1e-10))
    log_mel = np.maximum(log_mel, log_mel.max() - 8.0)
    return ((log_mel + 4.0) / 4.0).astype(np.float32)


def pad_or_trim_audio(audio: np.ndarray, n_samples: int = 30 * SAMPLE_RATE
                      ) -> np.ndarray:
    """Whisper's ``pad_or_trim`` at the raw-audio level: zero-pad/trim to
    the fixed 30 s window before the mel transform, so padded silence
    normalizes to ``(log_spec.max() - 8 + 4) / 4`` as in whisper."""
    if len(audio) >= n_samples:
        return audio[:n_samples]
    return np.pad(audio, (0, n_samples - len(audio)))


def pad_or_trim_mel(mel: np.ndarray, target_frames: int = 3000) -> np.ndarray:
    """Fixed-context shape guard on the mel time axis (zero-padding is a
    fallback for callers feeding unpadded audio)."""
    T = mel.shape[0]
    if T >= target_frames:
        return mel[:target_frames]
    return np.pad(mel, ((0, target_frames - T), (0, 0)))


def mel_windows(audio: np.ndarray, frames: int, max_windows: int):
    """Raw PCM → ``(mels [W, frames, n_mels] f32, full_window_count)``.

    whisper/transcribe.py computes ONE log-mel over the whole clip plus a
    trailing window of silence — the normalizing ``log_spec.max()`` is
    global, not per-window — then slices 30 s segments; mirrored here. The
    caller logs truncation when ``full > W``."""
    window = frames * HOP_LENGTH
    full = max(1, -(-len(audio) // window))
    n_w = min(full, max_windows)
    padded = np.pad(audio[: n_w * window],
                    (0, (n_w + 1) * window - min(len(audio), n_w * window)))
    mel = log_mel_spectrogram(padded)
    return (np.stack([mel[w * frames:(w + 1) * frames]
                      for w in range(n_w)]), full)


def prep_mel_windows(path: str, frames: int, max_windows: int):
    """The transcript's host-side half in one call: audio decode → 30 s
    windowing → log-mel (``(mels or None, full_window_count)``)."""
    audio = decode_audio(path)
    if audio is None or len(audio) == 0:
        return None, 0
    return mel_windows(audio, frames, max_windows)
