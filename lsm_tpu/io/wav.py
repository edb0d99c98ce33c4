"""WAV decoding without librosa/soundfile.

The reference loads audio with `librosa.load(sr=16000, duration=1.0,
mono=True)` (create_dataset.py:26-27). Google Speech Commands v0.02 ships
16 kHz 16-bit PCM mono WAVs, so in the common case decoding is a header
parse + int16 -> float32 scale. This module provides:

- a vectorized NumPy RIFF/WAVE parser (PCM 8/16/32-bit and IEEE float),
- mono downmix (mean over channels, matching librosa's to_mono),
- a Kaiser-windowed-sinc resampler for non-16kHz files (the soxr_hq-class
  quality tier librosa defaults to, create_dataset.py:26; anti-aliased,
  ~120 dB stopband),
- a batch loader that right-pads/truncates to a fixed length and reports
  per-file errors instead of raising (matching the reference's skip-on-error
  behavior, create_dataset.py:34-36).

A native C++ multi-file decoder (lsm_tpu.io.native) is used when available;
this NumPy path is the portable fallback and the test oracle (the C++
resampler implements the identical kernel; tests/test_native.py pins them
together).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np


class WavError(ValueError):
    pass


def sniff_container(head: bytes) -> Optional[str]:
    """Identify a known NON-WAV audio container from its magic bytes.

    The reference's `librosa.load` (create_dataset.py:26) transparently
    decodes FLAC/OGG/MP3/... via soundfile/audioread; this build is
    RIFF-WAV only (Speech Commands ships 16 kHz PCM WAV), so the load
    path uses this to turn "not a RIFF/WAVE file" into an actionable
    unsupported-container error naming the format it saw.
    """
    if head[:4] == b"fLaC":
        return "FLAC"
    if head[:4] == b"OggS":
        return "Ogg (Vorbis/Opus/FLAC)"
    if head[:3] == b"ID3":
        return "MP3"
    if (
        len(head) >= 3 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0
        # A bare MPEG frame sync is only 11 bits — any binary starting
        # 0xFF 0xE0+ would match (e.g. a headerless PCM dump whose first
        # sample is a moderate negative int16). Require the rest of the
        # frame header to be valid too: layer bits != reserved(00),
        # bitrate nibble != invalid(0xF), sample-rate bits != reserved.
        and (head[1] >> 1) & 0x3 != 0
        and (head[2] >> 4) != 0xF
        and (head[2] >> 2) & 0x3 != 0x3
    ):
        return "MP3"
    if head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        return "AIFF"
    if head[4:8] == b"ftyp":
        return "MP4/M4A"
    return None


def unsupported_container_error(head: bytes) -> Optional[str]:
    """Actionable error string for a recognized non-WAV container head,
    or None if the bytes don't match a known container."""
    cont = sniff_container(head)
    if cont is None:
        return None
    return (
        f"unsupported audio container: {cont} — this build decodes "
        "RIFF-WAV only (Speech Commands is 16 kHz PCM WAV; the "
        "reference decodes other containers via librosa/soundfile, "
        "create_dataset.py:26). Convert first, e.g. "
        "`ffmpeg -i <file> -ar 16000 -ac 1 out.wav`."
    )


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE byte buffer -> (samples float32 (n, ch), rate)."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        msg = unsupported_container_error(data[:12])
        raise WavError(msg if msg is not None else "not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise WavError("missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # The real format code is the first 2 bytes of the SubFormat GUID
        # at offset 24 of the fmt body (cbSize-22 extension). Assuming
        # PCM here would decode an extensible IEEE-float file's bit
        # patterns as int32 — full-scale noise with no error raised.
        if len(fmt_body) >= 26:
            (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        else:
            raise WavError("extensible WAV without a SubFormat GUID")
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / 8388608.0
        else:
            raise WavError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise WavError(f"unsupported float bit depth {bits}")
    else:
        raise WavError(f"unsupported audio format {audio_format}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    else:
        x = x.reshape(-1, 1)
    return x, rate


def to_mono(x: np.ndarray) -> np.ndarray:
    return x.mean(axis=1) if x.shape[1] > 1 else x[:, 0]


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear resampler (kept as a low-cost option and a quality foil for
    the sinc resampler's tests; not used by the load path)."""
    if src_rate == dst_rate:
        return x
    n_out = int(round(len(x) * dst_rate / src_rate))
    if n_out <= 1 or len(x) <= 1:
        return np.zeros(max(n_out, 0), dtype=np.float32)
    pos = np.arange(n_out, dtype=np.float64) * (len(x) - 1) / (n_out - 1)
    lo = np.minimum(pos.astype(np.int64), len(x) - 2)
    frac = (pos - lo).astype(np.float32)
    return (x[lo] * (1 - frac) + x[lo + 1] * frac).astype(np.float32)


# Kaiser-windowed sinc parameters shared with native/wavio.cpp — keep in
# sync. zeros=16 crossings, beta for ~120 dB stopband (A=120:
# beta = 0.1102*(A-8.7)), rolloff keeps the transition band under Nyquist.
_SINC_ZEROS = 16
_SINC_BETA = 12.26526
_SINC_ROLLOFF = 0.945


def resample_sinc(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Band-limited resampling via a Kaiser-windowed sinc kernel.

    The quality tier of librosa's default soxr_hq (create_dataset.py:26):
    anti-aliasing low-pass at min(1, ratio) * rolloff of the source
    Nyquist, 16 zero crossings, Kaiser beta ~12.27 (~120 dB stopband).
    Output sample i sits at source position i * src/dst (time alignment,
    matching soxr/resampy), zero-padded outside the signal.
    """
    if src_rate == dst_rate:
        return np.asarray(x, np.float32)
    n_in = len(x)
    ratio = dst_rate / src_rate
    n_out = int(round(n_in * ratio))
    if n_out <= 1 or n_in <= 1:
        return np.zeros(max(n_out, 0), dtype=np.float32)

    fc = min(1.0, ratio) * _SINC_ROLLOFF
    half = _SINC_ZEROS / fc                       # kernel half-width (src samples)
    pos = np.arange(n_out, dtype=np.float64) / ratio
    lo = np.floor(pos - half).astype(np.int64) + 1
    n_taps = int(np.ceil(2 * half))
    idx = lo[:, None] + np.arange(n_taps)[None, :]
    t = pos[:, None] - idx                        # in (-half, half]
    u = t / half
    win = np.i0(_SINC_BETA * np.sqrt(np.maximum(0.0, 1.0 - u * u)))
    win /= np.i0(_SINC_BETA)
    w = fc * np.sinc(fc * t) * win
    valid = (idx >= 0) & (idx < n_in)
    xi = np.where(valid, np.asarray(x, np.float64)[np.clip(idx, 0, n_in - 1)], 0.0)
    return (xi * w).sum(axis=1).astype(np.float32)


def load_wav(
    path: Path, sample_rate: int = 16000, duration: Optional[float] = None
) -> np.ndarray:
    """Decode one file -> float32 mono at sample_rate (duration-truncated)."""
    x, rate = decode_wav(Path(path).read_bytes())
    y = to_mono(x)
    if duration is not None:
        # librosa truncates at the SOURCE rate before resampling.
        y = y[: int(duration * rate)]
    y = resample_sinc(y, rate, sample_rate)
    return y.astype(np.float32)


def to_pcm16_wire(batch: np.ndarray) -> np.ndarray:
    """(n, T) f32 audio -> int16 PCM for the device wire.

    For PCM16-sourced audio (every Speech Commands file) the decoded f32
    samples are exactly n/32768, so this round-trip is LOSSLESS and the
    device-side /32768 in featurize_batch reproduces the f32 pipeline
    bit-for-bit — at half the host-to-device bytes of f32. Audio from float/24-bit
    sources or the Kaiser resampler quantizes at the int16 step (~3e-5),
    the same information the reference's own 16-bit corpus carries.
    """
    return np.clip(
        np.asarray(batch, np.float32) * 32768.0, -32768.0, 32767.0
    ).astype(np.int16)


def load_audio_batch(
    paths: Sequence[Path],
    sample_rate: int = 16000,
    duration: float = 1.0,
    use_native: bool = True,
    dtype: str = "float32",
) -> Tuple[np.ndarray, List[int], List[Tuple[Path, str]]]:
    """Decode many files -> (batch (n_ok, T), kept indices, errors).

    Right-pads with zeros / truncates to exactly sample_rate*duration samples
    (create_dataset.py:28-32). Decode failures are collected, not raised
    (create_dataset.py:34-36).

    dtype="int16" returns the PCM16 device wire (see to_pcm16_wire): the
    native decoder memcpys mono-PCM16-at-target-rate files straight into
    the batch, and featurize_batch converts on device — half the H2D
    bytes on the cold disk->predictions path, bit-equal for PCM16
    sources.

    dtype="ulaw" returns the uint8 G.711 mu-law wire (ops/ulaw.py):
    QUARTER of the f32 H2D bytes, decoded to f32 inside the jitted
    featurizer. Lossy (~38 dB speech SNR) but measured accuracy-neutral
    end to end (tests/test_ulaw.py) — for bandwidth-constrained ingest;
    int16 stays the bit-transparent default.
    """
    target = int(sample_rate * duration)
    if use_native:
        try:
            from lsm_tpu.io import native

            if native.available() and (
                (dtype != "int16" or native.supports_i16())
                and (dtype != "ulaw" or native.supports_ulaw())
            ):
                return native.load_audio_batch(
                    paths, sample_rate, duration, dtype=dtype
                )
        except Exception:
            pass

    rows, kept, errors = [], [], []
    for i, p in enumerate(paths):
        try:
            y = load_wav(p, sample_rate, duration)
        except Exception as e:  # noqa: BLE001 - mirror reference skip-on-error
            errors.append((Path(p), str(e)))
            continue
        if len(y) < target:
            y = np.pad(y, (0, target - len(y)))
        rows.append(y[:target])
        kept.append(i)
    batch = (
        np.stack(rows).astype(np.float32)
        if rows
        else np.zeros((0, target), np.float32)
    )
    if dtype == "int16":
        return to_pcm16_wire(batch), kept, errors
    if dtype == "ulaw":
        from lsm_tpu.ops.ulaw import encode_ulaw

        # Byte-identical to the native ulaw path: PCM16 samples round-trip
        # through f32 exactly (n/32768 * 32768 truncates back to n), and
        # zero padding encodes to 0xFF just like the native row memset.
        return encode_ulaw(to_pcm16_wire(batch)), kept, errors
    return batch, kept, errors


def write_wav(path: Path, audio: np.ndarray, rate: int = 16000) -> None:
    """Write mono 16-bit PCM (for tests and synthetic datasets)."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
