"""Batched on-device feature extraction: padded wavs -> MFCC / log-fbank
(port of ``asr_study_tpu/features/device.py``).

This is the plain PyTorch version of the chain.  The DFT is a matmul
against fixed cos/sin tables, framing is an index gather, and deltas use
per-utterance edge replication so that a padded batch matches the NumPy
oracle (``features/audio.py``) row for row.  The spectral core
(:func:`spectral_plain`) is the plain version of the fbank kernel in
``features/fbank.py``; the parts around it (``_prep``, ``_delta_device``,
``_finalize``) are shared by both featurizers.

Operator tables come from the oracle module ``features/audio.py`` and are
built in float64 on the host, then cast to float32 on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from asr_study_torch.features import audio

F32_EPS = float(np.finfo(np.float32).eps)


def device_num_frames(wav_lengths: torch.Tensor, frame_len: int,
                      frame_step: int, center: bool = False) -> torch.Tensor:
    """Vector version of ``audio.num_frames`` (both framing conventions),
    with an integer ceil-division (exact for any int32 length)."""
    if center:
        return 1 + torch.div(wav_lengths, frame_step, rounding_mode="floor")
    extra = torch.div(wav_lengths - frame_len + frame_step - 1, frame_step,
                      rounding_mode="floor")
    return torch.where(wav_lengths <= frame_len, 1, 1 + extra).to(
        wav_lengths.dtype)


def _center_pad_batch(pre: torch.Tensor, wav_lengths: torch.Tensor, pad: int,
                      pad_mode: str) -> torch.Tensor:
    """librosa centering for a padded batch [B, N] -> [B, N + 2*pad].

    The left reflection is the same for every row; the right one pivots on
    each row's own length.  Rows no longer than ``pad`` keep zeros there
    (as the JAX version does)."""
    if pad_mode == "constant":
        return torch.nn.functional.pad(pre, (pad, pad))
    if pad_mode != "reflect":
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    left = pre[:, 1: pad + 1].flip(1)
    body = torch.nn.functional.pad(pre, (0, pad))
    j = torch.arange(pad, device=pre.device)
    ln = wav_lengths.to(torch.int64)[:, None]
    # out[ln + j] = sig[ln - 2 - j]: numpy's reflect, edge excluded
    src = (ln - 2 - j).clamp_min(0)
    tail = torch.gather(body, 1, src)
    tail = torch.where(ln > pad, tail, 0.0)
    body = body.scatter(1, ln + j, tail)
    return torch.cat([left, body], dim=1)


def _dft_matrices(frame_len: int, nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases [frame_len, nfft//2+1]; the zero-padding to nfft
    is folded in (its rows would be zero, so they are absent)."""
    n = np.arange(frame_len)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _fft_twiddles(nfft: int) -> np.ndarray:
    """The FFT design's twiddles: [nfft, 2] float32 (cos, -sin) of
    2 pi k / nfft, i.e. e^{-2 pi i k / nfft}, computed in float64 and
    rounded once."""
    ang = 2.0 * np.pi * np.arange(nfft) / nfft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def _mel_bands(mel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each filter's band of a [K, M] filterbank -> (bands [M, 2] int32: the
    first and last nonzero bin, (0, -1) for an all-zero filter; the band
    weights [sum of widths] float32, filter by filter).  Summing a filter
    over its band in ascending bin order equals the dense sum with its
    zeros left out, whatever the filterbank."""
    mel = np.asarray(mel, dtype=np.float32)
    bands = np.zeros((mel.shape[1], 2), np.int32)
    bands[:, 1] = -1
    packed = []
    for m in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, m])
        if nz.size:
            bands[m] = nz[0], nz[-1]
            packed.append(mel[nz[0]: nz[-1] + 1, m])
    packed = np.concatenate(packed) if packed else np.zeros(0, np.float32)
    return bands, packed


def _delta_device(feat: torch.Tensor, lengths: torch.Tensor,
                  n: int = 2) -> torch.Tensor:
    """Regression delta with per-utterance edge replication.

    feat [B, T, F], lengths [B] -> [B, T, F]; equals ``audio.delta`` on
    each utterance's first ``lengths[b]`` frames.  Reads past the last
    real frame are clipped to it; frames beyond ``lengths[b]`` are
    garbage that every consumer masks."""
    t_max = feat.shape[1]
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    last = (lengths.to(torch.int64) - 1).clamp_min(0)              # [B]
    t_idx = torch.arange(t_max, device=feat.device)[None, :, None]
    idx_last = last[:, None, None].expand(-1, 1, feat.shape[2])
    x_last = torch.gather(feat, 1, idx_last)                      # [B, 1, F]
    x_first = feat[:, :1, :]
    last_b = last[:, None, None]
    out = torch.zeros_like(feat)
    for k in range(1, n + 1):
        fwd = torch.cat([feat[:, k:, :], torch.zeros_like(feat[:, :k, :])],
                        dim=1)
        fwd = torch.where(t_idx + k > last_b, x_last, fwd)
        bwd = torch.cat([x_first.expand(-1, k, -1), feat[:, :-k, :]], dim=1)
        out = out + k * (fwd - bwd)
    return out / denom


@dataclass(frozen=True)
class SpectralChain:
    """Everything the spectral core needs: static sizes, the output kind
    and the float32 operator tables (all on one device)."""

    kind: str               # 'mfcc' | 'logfbank' | 'fbank'
    frame_len: int
    frame_step: int
    nfft: int
    append_energy: bool     # mfcc: c0 <- log energy; logfbank: + column
    floor: float            # power floor before each log
    window: torch.Tensor    # [L]
    cos: torch.Tensor       # [L, K]
    sin: torch.Tensor       # [L, K]
    mel: torch.Tensor       # [K, M]
    dct: torch.Tensor       # [M, C]
    lift: torch.Tensor      # [C]
    # the fbank kernel's FFT design (features/fbank.py): e^{-2 pi i k/nfft}
    # [nfft, 2], each filter's first and last nonzero bin [M, 2] int32 and
    # the band weights, filter by filter [sum of widths]
    twiddle: torch.Tensor
    mel_bands: torch.Tensor
    mel_packed: torch.Tensor

    @property
    def num_out(self) -> int:
        if self.kind == "mfcc":
            return self.dct.shape[1]
        return self.mel.shape[1] + int(
            self.kind == "logfbank" and self.append_energy)


def spectral_plain(chain: SpectralChain, pre: torch.Tensor,
                   t_out: int) -> torch.Tensor:
    """Plain version of the fbank kernel: prepared signal [B, N] ->
    base features [B, t_out, chain.num_out] (MFCC before deltas, log-mel
    with optional energy column, or linear mel)."""
    need = (t_out - 1) * chain.frame_step + chain.frame_len
    if need > pre.shape[1]:
        pre = torch.nn.functional.pad(pre, (0, need - pre.shape[1]))
    idx = (torch.arange(t_out, device=pre.device)[:, None] * chain.frame_step
           + torch.arange(chain.frame_len, device=pre.device)[None, :])
    frames = pre[:, idx] * chain.window                      # [B, T, L]
    re = torch.matmul(frames, chain.cos)
    im = torch.matmul(frames, chain.sin)
    pspec = (re * re + im * im) / chain.nfft                 # [B, T, K]
    energy = pspec.sum(-1).clamp_min(F32_EPS)
    feat = torch.matmul(pspec, chain.mel).clamp_min(F32_EPS)
    if chain.kind == "fbank":
        return feat
    logfeat = torch.log(feat.clamp_min(chain.floor))
    log_e = torch.log(energy.clamp_min(chain.floor))
    if chain.kind == "mfcc":
        cep = torch.matmul(logfeat, chain.dct) * chain.lift
        if chain.append_energy:
            cep = torch.cat([log_e[..., None], cep[..., 1:]], dim=-1)
        return cep
    if chain.append_energy:
        return torch.cat([logfeat, log_e[..., None]], dim=-1)
    return logfeat


class DeviceFeaturizer:
    """Batched feature extractor on one torch device (plain version).

    ``kind``: 'raw' | 'fbank' | 'logfbank' | 'mfcc'; the other parameters
    mirror the JAX ``DeviceFeaturizer`` and the NumPy oracle classes.  Call
    with a padded batch::

        feats, feat_lengths = featurizer(wavs [B, N], wav_lengths [B])
    """

    def __init__(
        self,
        kind: str = "mfcc",
        fs: int = 16000,
        win_len: float = 0.025,
        win_step: float = 0.01,
        nfilt: int = 40,
        nfft: int = 512,
        low_freq: float = 0.0,
        high_freq: Optional[float] = None,
        preemph: float = 0.97,
        htk=audio._UNSET,
        window=audio._UNSET,
        center=audio._UNSET,
        pad_mode: str = "reflect",
        filterbank=audio._UNSET,
        fb_norm=audio._UNSET,
        convention: str = "reference",
        num_cep: int = 13,
        cep_lifter: int = 22,
        append_energy: Optional[bool] = None,
        d: Optional[bool] = None,
        dd: Optional[bool] = None,
        mean_norm: bool = False,
        var_norm: bool = False,
        eps: float = audio.EPS,
        log_floor: float = 0.0,
        device: torch.device | str = "cpu",
    ):
        if kind not in ("raw", "fbank", "logfbank", "mfcc"):
            raise ValueError(f"unknown device feature kind {kind!r}")
        if append_energy is None:
            append_energy = kind == "mfcc"
        if d is None:
            d = kind == "mfcc"
        if dd is None:
            dd = kind == "mfcc"
        self.kind = kind
        self.fs = fs
        self.device = torch.device(device)
        self.frame_len = int(round(win_len * fs))
        self.frame_step = int(round(win_step * fs))
        self.nfilt = nfilt
        self.nfft = nfft
        self.preemph = preemph
        self.convention = convention
        (self.htk, self.window, self.center, self.filterbank,
         self.fb_norm) = audio.resolve_convention(
            convention, htk, window, center, filterbank, fb_norm
        )
        self.pad_mode = pad_mode
        self.num_cep = num_cep
        self.cep_lifter = cep_lifter
        self.append_energy = append_energy
        self.d = d
        self.dd = dd
        self.mean_norm = mean_norm
        self.var_norm = var_norm
        self.eps = eps
        # power-domain floor before any log (audio._SpectralFeature)
        self.log_floor = max(float(log_floor), F32_EPS)
        self.chain = None
        if kind == "raw":
            return

        def table(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=self.device).contiguous()

        cos_m, sin_m = _dft_matrices(self.frame_len, nfft)
        mel = audio.mel_filterbank(
            nfilt, nfft, fs, low_freq, high_freq, self.htk,
            construction=self.filterbank, norm=self.fb_norm,
        ).T.astype(np.float32)
        bands, packed = _mel_bands(mel)
        lift = (1.0 + (cep_lifter / 2.0) * np.sin(
            np.pi * np.arange(num_cep) / cep_lifter)
            if cep_lifter > 0 else np.ones(num_cep))
        self.chain = SpectralChain(
            kind=kind,
            frame_len=self.frame_len,
            frame_step=self.frame_step,
            nfft=nfft,
            append_energy=bool(append_energy) and kind != "fbank",
            # linear fbank takes no log: keep the eps-only floor there
            floor=F32_EPS if kind == "fbank" else self.log_floor,
            window=table(audio.get_window(self.window)(self.frame_len)),
            cos=table(cos_m),
            sin=table(sin_m),
            mel=table(mel),
            dct=table(audio.dct2_ortho_matrix(nfilt, num_cep).T),
            lift=table(lift),
            twiddle=table(_fft_twiddles(nfft)),
            mel_bands=torch.as_tensor(bands, device=self.device),
            mel_packed=table(packed),
        )

    @property
    def num_feats(self) -> int:
        if self.kind == "raw":
            return 1
        if self.kind == "fbank":
            return self.nfilt
        if self.kind == "logfbank":
            base = self.nfilt + (1 if self.append_energy else 0)
            return base * (1 + int(self.d) + int(self.dd))
        return self.num_cep * (1 + int(self.d) + int(self.dd))

    def _finalize(self, out: torch.Tensor, feat_lengths: torch.Tensor):
        """Per-utterance CMVN over the real frames, then zero the tail."""
        t_out = out.shape[1]
        maskf = (torch.arange(t_out, device=out.device)[None, :]
                 < feat_lengths[:, None]).to(out.dtype)[..., None]
        if self.mean_norm or self.var_norm:
            n = feat_lengths.to(out.dtype).clamp_min(1.0)[:, None, None]
            mu = (out * maskf).sum(1, keepdim=True) / n
            if self.var_norm:
                var = (((out - mu) * maskf) ** 2).sum(1, keepdim=True) / n
                std = torch.sqrt(var)
            if self.mean_norm:
                out = out - mu
            if self.var_norm:
                out = out / (std + self.eps)
        return out * maskf, feat_lengths

    def _prep(self, wavs: torch.Tensor, wav_lengths: torch.Tensor):
        """Pre-emphasis, zeroing beyond each length (the oracle pads zeros
        after pre-emphasis) and librosa centering when enabled.  Returns
        (signal, frame count, per-row frame lengths); framing reads the
        signal at t*frame_step in both conventions."""
        n_samples = wavs.shape[1]
        pre = torch.cat(
            [wavs[:, :1], wavs[:, 1:] - self.preemph * wavs[:, :-1]], dim=1)
        valid = (torch.arange(n_samples, device=wavs.device)[None, :]
                 < wav_lengths[:, None])
        pre = torch.where(valid, pre, 0.0)
        t_out = int(audio.num_frames(
            n_samples, self.frame_len, self.frame_step, center=self.center))
        feat_lengths = device_num_frames(
            wav_lengths, self.frame_len, self.frame_step, center=self.center)
        if self.center:
            pre = _center_pad_batch(pre, wav_lengths, self.frame_len // 2,
                                    self.pad_mode)
        return pre, t_out, feat_lengths

    def _spectral(self, pre: torch.Tensor, t_out: int) -> torch.Tensor:
        return spectral_plain(self.chain, pre, t_out)

    def _transform(self, wavs: torch.Tensor, wav_lengths: torch.Tensor):
        wavs = wavs.to(torch.float32)
        wav_lengths = wav_lengths.to(torch.int32)
        if self.kind == "raw":
            return self._finalize(wavs[..., None], wav_lengths)
        pre, t_out, feat_lengths = self._prep(wavs, wav_lengths)
        base = self._spectral(pre, t_out)
        if self.kind == "fbank":
            return self._finalize(base, feat_lengths)
        outs = [base]
        if self.d:
            outs.append(_delta_device(outs[-1], feat_lengths))
        if self.dd:
            outs.append(_delta_device(outs[-1], feat_lengths))
        return self._finalize(torch.cat(outs, dim=-1), feat_lengths)

    def __call__(self, wavs, wav_lengths):
        return self._transform(
            torch.as_tensor(wavs, device=self.device),
            torch.as_tensor(wav_lengths, device=self.device))
