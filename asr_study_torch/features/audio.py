"""NumPy feature-extraction oracle (reference-parity CPU path).

Copied from ``asr_study_tpu/features/audio.py`` so that the port imports
nothing of the JAX package: the framing, spectra, mel, delta and DCT
helpers, the convention table, and the ``FBank``, ``LogFbank`` and ``MFCC``
classes, without the JAX package's registry decorators and without its
``Raw`` feature.  It imports numpy and the standard library only.

It mirrors the reference's preprocessing chain [ref:
preprocessing/audio.py] — wav -> framing -> (pre-emphasis) -> windowed STFT
-> mel filterbank -> log-energies / MFCC (+ delta / delta-delta) — in the
python_speech_features-style formulation the reference uses, with the
mel-scale convention (HTK vs. Slaney) configurable.

Defaults: fs=16 kHz, 25 ms window / 10 ms hop, 40 mel filters, 13 cepstra,
Hamming window, HTK mel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from asr_study_torch.features.wav import read_wav

EPS = 1e-10


# ---------------------------------------------------------------------------
# framing / spectra
# ---------------------------------------------------------------------------

def num_frames(signal_len: int, frame_len: int, frame_step: int,
               center: bool = False) -> int:
    """Frame count: tail zero-padded framing (1 frame if the signal is
    shorter than a window, else one per hop with a final padded frame), or
    librosa's ``center=True`` convention (frame t centered on t*hop:
    1 + floor(len/hop) frames)."""
    if center:
        return 1 + signal_len // frame_step
    if signal_len <= frame_len:
        return 1
    return 1 + int(math.ceil((signal_len - frame_len) / float(frame_step)))


def center_pad(signal: np.ndarray, pad: int,
               pad_mode: str = "reflect") -> np.ndarray:
    """librosa-style centering pad: ``pad`` samples on each side."""
    if pad_mode not in ("reflect", "constant"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    if len(signal) < 2 or pad_mode == "constant":
        return np.pad(signal, pad, mode="constant")
    return np.pad(signal, pad, mode="reflect")


def periodic_hann(n: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window — librosa/scipy ``fftbins=True``
    convention, NOT numpy's symmetric ``np.hanning``."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


_WINDOWS = {"hamming": np.hamming, "hann": periodic_hann}


def get_window(name) -> Callable[[int], np.ndarray]:
    """Window table lookup ('hamming' | 'hann'); callables pass through."""
    if callable(name):
        return name
    try:
        return _WINDOWS[name]
    except KeyError:
        raise ValueError(
            f"unknown window {name!r}; have {sorted(_WINDOWS)}"
        ) from None


def preemphasis(signal: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    if coeff == 0.0:
        return signal.astype(np.float64)
    return np.append(signal[0], signal[1:] - coeff * signal[:-1])


def frame_signal(
    signal: np.ndarray,
    frame_len: int,
    frame_step: int,
    window: Optional[np.ndarray] = None,
    n_frames: Optional[int] = None,
) -> np.ndarray:
    """Slice a 1-D signal into overlapping (zero-padded) frames [T, frame_len]."""
    signal = np.asarray(signal)
    nf = (n_frames if n_frames is not None
          else num_frames(len(signal), frame_len, frame_step))
    pad_len = (nf - 1) * frame_step + frame_len
    padded = np.concatenate(
        [signal,
         np.zeros(max(0, pad_len - len(signal)), dtype=signal.dtype)]
    )
    idx = np.arange(frame_len)[None, :] + frame_step * np.arange(nf)[:, None]
    frames = padded[idx]
    if window is not None:
        frames = frames * window[None, :]
    return frames


def power_spectrum(frames: np.ndarray, nfft: int) -> np.ndarray:
    """Per-frame power spectrum: (1/NFFT) * |rfft|^2 -> [T, nfft//2 + 1]."""
    mag = np.abs(np.fft.rfft(frames, nfft))
    return (1.0 / nfft) * np.square(mag)


# ---------------------------------------------------------------------------
# mel scale
# ---------------------------------------------------------------------------

def hz_to_mel(hz, htk: bool = True):
    hz = np.asarray(hz, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + hz / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (hz - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        hz >= min_log_hz,
        min_log_mel + np.log(np.maximum(hz, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(mel, htk: bool = True):
    mel = np.asarray(mel, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mel >= min_log_mel,
        min_log_hz * np.exp(logstep * (mel - min_log_mel)),
        freqs,
    )


def mel_filterbank(
    nfilt: int,
    nfft: int,
    sr: int,
    low_freq: float = 0.0,
    high_freq: Optional[float] = None,
    htk: bool = True,
    construction: str = "quantized",
    norm: Optional[str] = None,
) -> np.ndarray:
    """Triangular mel filterbank -> [nfilt, nfft//2 + 1].

    Two constructions (SURVEY.md tagged the reference's as MED-confidence,
    so both are first-class — parity with whichever the real reference
    used is a flag flip):

    - ``quantized``: breakpoints snapped to FFT bins via
      ``floor((nfft+1) * hz / sr)`` — the python_speech_features-style
      shape.
    - ``librosa``: triangles in continuous frequency space evaluated at
      the FFT bin frequencies ``k * sr / nfft`` (librosa.filters.mel).

    ``norm='slaney'`` applies librosa's area normalization (each triangle
    scaled by 2 / bandwidth); the mel SCALE itself (HTK vs Slaney) stays
    the independent ``htk`` flag.
    """
    high_freq = high_freq or sr / 2.0
    mel_pts = np.linspace(
        hz_to_mel(low_freq, htk), hz_to_mel(high_freq, htk), nfilt + 2
    )
    hz_pts = mel_to_hz(mel_pts, htk)
    if construction == "quantized":
        bins = np.floor((nfft + 1) * hz_pts / sr).astype(int)
        fbank = np.zeros((nfilt, nfft // 2 + 1))
        for j in range(nfilt):
            lo, mid, hi = bins[j], bins[j + 1], bins[j + 2]
            for i in range(lo, mid):
                fbank[j, i] = (i - lo) / max(mid - lo, 1)
            for i in range(mid, hi):
                fbank[j, i] = (hi - i) / max(hi - mid, 1)
    elif construction == "librosa":
        fft_freqs = np.arange(nfft // 2 + 1) * (sr / float(nfft))
        fdiff = np.diff(hz_pts)
        lower = (fft_freqs[None, :] - hz_pts[:-2, None]) / np.maximum(
            fdiff[:-1, None], np.finfo(np.float64).tiny
        )
        upper = (hz_pts[2:, None] - fft_freqs[None, :]) / np.maximum(
            fdiff[1:, None], np.finfo(np.float64).tiny
        )
        fbank = np.maximum(0.0, np.minimum(lower, upper))
    else:
        raise ValueError(
            f"unknown filterbank construction {construction!r} "
            "(have: quantized, librosa)"
        )
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: nfilt + 2] - hz_pts[:nfilt])
        fbank = fbank * enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unknown filterbank norm {norm!r}")
    return fbank


# ---------------------------------------------------------------------------
# deltas / lifter / dct
# ---------------------------------------------------------------------------

def delta(feat: np.ndarray, n: int = 2) -> np.ndarray:
    """Regression delta over a +-n frame window with edge replication."""
    if n < 1:
        raise ValueError("delta window must be >= 1")
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    padded = np.pad(feat, ((n, n), (0, 0)), mode="edge")
    out = np.zeros_like(feat, dtype=np.float64)
    for t in range(feat.shape[0]):
        window = padded[t : t + 2 * n + 1]
        out[t] = np.dot(np.arange(-n, n + 1), window) / denom
    return out


def lifter(cepstra: np.ndarray, l: int = 22) -> np.ndarray:
    if l <= 0:
        return cepstra
    ncoeff = cepstra.shape[1]
    lift = 1.0 + (l / 2.0) * np.sin(np.pi * np.arange(ncoeff) / l)
    return cepstra * lift[None, :]


def dct2_ortho_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_out, n_in] (scipy.fftpack.dct norm='ortho')."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return mat


# ---------------------------------------------------------------------------
# full chains (functional)
# ---------------------------------------------------------------------------

def fbank_features(
    signal: np.ndarray,
    sr: int = 16000,
    win_len: float = 0.025,
    win_step: float = 0.01,
    nfilt: int = 40,
    nfft: int = 512,
    low_freq: float = 0.0,
    high_freq: Optional[float] = None,
    preemph: float = 0.97,
    win_fun: Callable[[int], np.ndarray] = np.hamming,
    htk: bool = True,
    center: bool = False,
    pad_mode: str = "reflect",
    filterbank: str = "quantized",
    fb_norm: Optional[str] = None,
):
    """-> (mel-filterbank energies [T, nfilt], total frame energy [T]).

    ``center=True`` uses librosa's framing (frame t centered on t*hop,
    signal padded frame_len//2 per side with ``pad_mode``); matches
    librosa's effective sample coverage exactly for even frame_len (the
    real configs; odd frame_len diverges by one tail sample).  Note the
    affine conventions stay python_speech_features-style in BOTH modes:
    power spectra carry 1/NFFT and logs are natural — per-channel affine
    offsets in log domain, which CMVN (and any trained network) absorbs.
    """
    frame_len = int(round(win_len * sr))
    frame_step = int(round(win_step * sr))
    sig = preemphasis(signal, preemph)
    if center:
        nf = num_frames(len(signal), frame_len, frame_step, center=True)
        sig = center_pad(sig, frame_len // 2, pad_mode)
        frames = frame_signal(
            sig, frame_len, frame_step, win_fun(frame_len), n_frames=nf
        )
    else:
        frames = frame_signal(sig, frame_len, frame_step, win_fun(frame_len))
    pspec = power_spectrum(frames, nfft)
    energy = np.sum(pspec, axis=1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)
    fb = mel_filterbank(nfilt, nfft, sr, low_freq, high_freq, htk,
                        construction=filterbank, norm=fb_norm)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    return feat, energy


# ---------------------------------------------------------------------------
# Feature classes (reference API shape: Feature()(wav_path) -> [T, F])
# ---------------------------------------------------------------------------

class Feature:
    """Base feature extractor [ref: preprocessing/audio.py::Feature].

    Callable on a wav path or a raw signal array; subclasses implement
    ``_transform(signal) -> [T, F]``.  ``mean_norm``/``var_norm`` apply
    per-utterance CMVN.
    """

    def __init__(
        self,
        fs: int = 16000,
        mean_norm: bool = False,
        var_norm: bool = False,
        eps: float = EPS,
    ):
        self.fs = int(fs)
        self.mean_norm = mean_norm
        self.var_norm = var_norm
        self.eps = eps

    @property
    def num_feats(self) -> int:
        raise NotImplementedError

    def _transform(self, signal: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _load(self, audio) -> np.ndarray:
        if isinstance(audio, (str, bytes)):
            signal, _ = read_wav(audio, sr=self.fs)
            return signal
        return np.asarray(audio)

    def __call__(self, audio) -> np.ndarray:
        feats = self._transform(self._load(audio))
        if self.mean_norm:
            feats = feats - feats.mean(axis=0, keepdims=True)
        if self.var_norm:
            feats = feats / (feats.std(axis=0, keepdims=True) + self.eps)
        return np.ascontiguousarray(feats, dtype=np.float32)

    def __str__(self) -> str:
        return type(self).__name__.lower()


_UNSET = object()

# Per-convention defaults for the five convention-shaped knobs.  The
# reference's exact chain is MED-confidence recall (SURVEY.md §0), so both
# conventions are first-class: ``convention="librosa"`` flips every
# shape-changing default to librosa's (center framing + reflect pad,
# periodic-Hann window, Slaney mel scale, continuous-triangle filterbank
# with Slaney area norm); any knob passed explicitly still wins.
_CONVENTIONS = {
    "reference": dict(htk=True, window="hamming", center=False,
                      filterbank="quantized", fb_norm=None),
    "librosa": dict(htk=False, window="hann", center=True,
                    filterbank="librosa", fb_norm="slaney"),
}


def resolve_convention(convention: str, htk=_UNSET, window=_UNSET,
                       center=_UNSET, filterbank=_UNSET, fb_norm=_UNSET):
    """-> (htk, window, center, filterbank, fb_norm) with convention
    defaults filled in for any knob left unset."""
    try:
        d = _CONVENTIONS[convention]
    except KeyError:
        raise ValueError(
            f"unknown feature convention {convention!r}; "
            f"have {sorted(_CONVENTIONS)}"
        ) from None
    pick = lambda v, k: d[k] if v is _UNSET else v  # noqa: E731
    return (pick(htk, "htk"), pick(window, "window"), pick(center, "center"),
            pick(filterbank, "filterbank"), pick(fb_norm, "fb_norm"))


class _SpectralFeature(Feature):
    def __init__(
        self,
        fs: int = 16000,
        win_len: float = 0.025,
        win_step: float = 0.01,
        nfilt: int = 40,
        nfft: int = 512,
        low_freq: float = 0.0,
        high_freq: Optional[float] = None,
        preemph: float = 0.97,
        htk=_UNSET,
        window=_UNSET,
        center=_UNSET,
        pad_mode: str = "reflect",
        filterbank=_UNSET,
        fb_norm=_UNSET,
        convention: str = "reference",
        log_floor: float = 0.0,
        **kw,
    ):
        super().__init__(fs=fs, **kw)
        self.win_len = win_len
        self.win_step = win_step
        self.nfilt = nfilt
        self.nfft = nfft
        self.low_freq = low_freq
        self.high_freq = high_freq
        self.preemph = preemph
        self.convention = convention
        (self.htk, self.window, self.center, self.filterbank,
         self.fb_norm) = resolve_convention(
            convention, htk, window, center, filterbank, fb_norm
        )
        self.pad_mode = pad_mode
        get_window(self.window)   # validate early
        # Optional ABSOLUTE power-domain floor applied to mel energies and
        # total frame energy before any log.  0.0 = reference behavior
        # (only exact zeros floored at eps).  A floor ~60-80 dB below
        # typical frame power bounds the log-domain divergence between this
        # f64 oracle and the f32 device/Pallas paths on near-silent
        # channels (where log amplifies eps-level DFT differences) —
        # VERDICT r1 "device-feature parity tolerance".  Applied
        # identically in all three implementations.
        self.log_floor = float(log_floor)

    def _floor(self, arr: np.ndarray) -> np.ndarray:
        return np.maximum(arr, self.log_floor) if self.log_floor > 0 else arr

    def _fbank(self, signal):
        return fbank_features(
            signal,
            sr=self.fs,
            win_len=self.win_len,
            win_step=self.win_step,
            nfilt=self.nfilt,
            nfft=self.nfft,
            low_freq=self.low_freq,
            high_freq=self.high_freq,
            preemph=self.preemph,
            win_fun=get_window(self.window),
            htk=self.htk,
            center=self.center,
            pad_mode=self.pad_mode,
            filterbank=self.filterbank,
            fb_norm=self.fb_norm,
        )


class FBank(_SpectralFeature):
    """Linear mel-filterbank energies [T, nfilt]
    [ref: preprocessing/audio.py::FBank]."""

    @property
    def num_feats(self) -> int:
        return self.nfilt

    def _transform(self, signal: np.ndarray) -> np.ndarray:
        feat, _ = self._fbank(signal)
        return feat


class LogFbank(_SpectralFeature):
    """Log mel-filterbank energies, optionally with appended log-energy and
    deltas [ref: preprocessing/audio.py::LogFbank]."""

    def __init__(self, d: bool = False, dd: bool = False, append_energy: bool = False, **kw):
        super().__init__(**kw)
        self.d = d
        self.dd = dd or False
        self.append_energy = append_energy

    @property
    def num_feats(self) -> int:
        base = self.nfilt + (1 if self.append_energy else 0)
        return base * (1 + int(self.d) + int(self.dd))

    def _transform(self, signal: np.ndarray) -> np.ndarray:
        feat, energy = self._fbank(signal)
        feat = np.log(self._floor(feat))
        if self.append_energy:
            feat = np.hstack([feat, np.log(self._floor(energy))[:, None]])
        out = [feat]
        if self.d:
            out.append(delta(feat, 2))
        if self.dd:
            out.append(delta(out[-1], 2))
        return np.hstack(out)


class MFCC(_SpectralFeature):
    """Mel-frequency cepstral coefficients with liftering, optional energy
    replacement of c0, and delta / delta-delta appends
    [ref: preprocessing/audio.py::MFCC].
    """

    def __init__(
        self,
        num_cep: int = 13,
        cep_lifter: int = 22,
        append_energy: bool = True,
        d: bool = True,
        dd: bool = True,
        **kw,
    ):
        super().__init__(**kw)
        self.num_cep = num_cep
        self.cep_lifter = cep_lifter
        self.append_energy = append_energy
        self.d = d
        self.dd = dd

    @property
    def num_feats(self) -> int:
        return self.num_cep * (1 + int(self.d) + int(self.dd))

    def _transform(self, signal: np.ndarray) -> np.ndarray:
        feat, energy = self._fbank(signal)
        logfeat = np.log(self._floor(feat))
        dct = dct2_ortho_matrix(self.nfilt, self.num_cep)
        cep = logfeat @ dct.T
        cep = lifter(cep, self.cep_lifter)
        if self.append_energy:
            cep[:, 0] = np.log(self._floor(energy))
        out = [cep]
        if self.d:
            out.append(delta(cep, 2))
        if self.dd:
            out.append(delta(out[-1], 2))
        return np.hstack(out)
