"""SpecAugment and WavAugment, training-time augmentation on the device
(port of ``asr_study_tpu/features/augment.py``).

Each transform is split in two: :meth:`draws` takes its random numbers from
the caller's ``torch.Generator`` on the tensors' device, and :meth:`apply`
is a pure function from those draws to the output, in the JAX module's
arithmetic (so the same draws give the same output: the masks exactly, the
gain and noise to float rounding).  JAX's RNG is not reproduced.

SpecAugment, per utterance:
- ``freq_masks`` frequency bands, each of width ~ U{0..freq_width}, start
  uniform over the valid range, masked to 0 across all frames;
- ``time_masks`` frame spans, each of width ~ U{0..floor(time_ratio *
  length)}, start uniform within the utterance's valid frames: padding is
  never counted or masked.

WavAugment, per utterance of a raw padded batch, before the in-step
featurizer: a random gain U[-gain_db, +gain_db] dB, and additive white
Gaussian noise at an SNR U[noise_snr_min, noise_snr_max] dB against the
utterance's RMS over its real samples (off unless ``noise_snr_max`` > 0).
Padding samples stay exactly 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _uniform(shape, generator: Optional[torch.Generator],
             device: torch.device, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    """U[lo, hi) float32 as ``jax.random.uniform`` forms it from U[0, 1):
    ``max(lo, u * (hi - lo) + lo)``."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    if lo == 0.0 and hi == 1.0:
        return u
    return torch.clamp_min(u * (hi - lo) + lo, lo)


class SpecAugment:
    """Callable ``(inputs [B, T, F], input_lengths [B], generator) ->
    inputs``."""

    def __init__(self, freq_masks: int = 2, freq_width: int = 8,
                 time_masks: int = 2, time_ratio: float = 0.05):
        if freq_masks < 0 or time_masks < 0:
            raise ValueError("mask counts must be >= 0")
        if freq_width < 0:
            raise ValueError(f"freq_width must be >= 0, got {freq_width}")
        if not 0.0 <= time_ratio <= 1.0:
            raise ValueError(
                f"time_ratio must be in [0, 1], got {time_ratio}"
            )
        self.freq_masks = int(freq_masks)
        self.freq_width = int(freq_width)
        self.time_masks = int(time_masks)
        self.time_ratio = float(time_ratio)

    def __repr__(self) -> str:
        return (
            f"SpecAugment(freq_masks={self.freq_masks}, "
            f"freq_width={self.freq_width}, time_masks={self.time_masks}, "
            f"time_ratio={self.time_ratio})"
        )

    def draws(self, batch: int, generator: Optional[torch.Generator],
              device: torch.device
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """-> (u_freq [B, freq_masks, 2], u_time [B, time_masks, 2]) in
        [0, 1): per mask a width draw and a start draw; None where that
        kind of mask is off."""
        u_f = u_t = None
        if self.freq_masks and self.freq_width:
            u_f = _uniform((batch, self.freq_masks, 2), generator, device)
        if self.time_masks and self.time_ratio > 0:
            u_t = _uniform((batch, self.time_masks, 2), generator, device)
        return u_f, u_t

    def apply(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
              u_f: Optional[torch.Tensor], u_t: Optional[torch.Tensor]
              ) -> torch.Tensor:
        b, t, f = inputs.shape
        dev = inputs.device
        keep = torch.ones((b, t, f), dtype=torch.bool, device=dev)
        if u_f is not None:
            w_cap = min(self.freq_width, f)
            w = torch.floor(u_f[..., 0] * (w_cap + 1)).to(torch.int32)
            start = torch.floor(u_f[..., 1] * (f - w + 1)).to(torch.int32)
            idx = torch.arange(f, device=dev)[None, None, :]
            band = (idx >= start[..., None]) & (idx < (start + w)[..., None])
            keep &= ~band.any(dim=1)[:, None, :]
        if u_t is not None:
            lengths = input_lengths.to(torch.int32)
            w_cap = torch.floor(
                self.time_ratio * lengths.to(torch.float32)
            ).to(torch.int32)[:, None]
            w = torch.floor(u_t[..., 0] * (w_cap + 1)).to(torch.int32)
            start = torch.floor(
                u_t[..., 1] * (lengths[:, None] - w + 1)).to(torch.int32)
            idx = torch.arange(t, device=dev)[None, None, :]
            span = (idx >= start[..., None]) & (idx < (start + w)[..., None])
            keep &= ~span.any(dim=1)[:, :, None]
        return torch.where(keep, inputs, torch.zeros((), dtype=inputs.dtype,
                                                     device=dev))

    def __call__(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return self.apply(inputs, input_lengths,
                          *self.draws(inputs.shape[0], generator,
                                      inputs.device))


class WavAugment:
    """Callable ``(wavs [B, N], wav_lengths [B], generator) -> wavs``."""

    def __init__(self, gain_db: float = 0.0,
                 noise_snr_min: float = 0.0,
                 noise_snr_max: float = 0.0):
        if gain_db < 0:
            raise ValueError(f"gain_db must be >= 0, got {gain_db}")
        if noise_snr_min and not noise_snr_max:
            # noise is gated on noise_snr_max, so min alone would be a
            # silent no-op for the whole training run
            raise ValueError(
                f"noise_snr_min={noise_snr_min} without noise_snr_max "
                "would disable noise entirely; set noise_snr_max too"
            )
        if noise_snr_min > noise_snr_max:
            raise ValueError(
                f"noise_snr_min {noise_snr_min} > noise_snr_max "
                f"{noise_snr_max}"
            )
        self.gain_db = float(gain_db)
        self.noise_snr_min = float(noise_snr_min)
        self.noise_snr_max = float(noise_snr_max)

    def __repr__(self) -> str:
        return (
            f"WavAugment(gain_db={self.gain_db}, "
            f"noise_snr_min={self.noise_snr_min}, "
            f"noise_snr_max={self.noise_snr_max})"
        )

    def draws(self, batch: int, n: int,
              generator: Optional[torch.Generator], device: torch.device
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                         Optional[torch.Tensor]]:
        """-> (gain in dB [B, 1], SNR in dB [B, 1], standard normal noise
        [B, N]); None where that part is off."""
        db = snr = noise = None
        if self.gain_db > 0:
            db = _uniform((batch, 1), generator, device, -self.gain_db,
                          self.gain_db)
        if self.noise_snr_max > 0:
            snr = _uniform((batch, 1), generator, device, self.noise_snr_min,
                           self.noise_snr_max)
            noise = torch.randn((batch, n), generator=generator,
                                device=device, dtype=torch.float32)
        return db, snr, noise

    @staticmethod
    def apply(wavs: torch.Tensor, wav_lengths: torch.Tensor,
              db: Optional[torch.Tensor], snr: Optional[torch.Tensor],
              noise: Optional[torch.Tensor]) -> torch.Tensor:
        n = wavs.shape[1]
        mask = (torch.arange(n, device=wavs.device)[None, :]
                < wav_lengths[:, None].to(torch.int32))
        if db is not None:
            wavs = wavs * torch.pow(10.0, db / 20.0)
        if snr is not None:
            # RMS over each utterance's real samples, after the gain: the
            # SNR is against the signal the featurizer sees
            denom = torch.clamp_min(
                mask.sum(dim=1, keepdim=True).to(torch.float32), 1.0)
            rms = torch.sqrt(
                (torch.where(mask, wavs, 0.0) ** 2).sum(dim=1, keepdim=True)
                / denom)
            sigma = rms * torch.pow(10.0, -snr / 20.0)
            wavs = wavs + torch.where(mask, noise * sigma, 0.0)
        # padding stays exactly zero whatever the ops above did
        return torch.where(mask, wavs, 0.0)

    def __call__(self, wavs: torch.Tensor, wav_lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return self.apply(wavs, wav_lengths,
                          *self.draws(wavs.shape[0], wavs.shape[1],
                                      generator, wavs.device))


def _parse_kv(spec: str, flag: str, keys: dict):
    """Shared ``"k=v,..."`` parser (empty string -> all defaults)."""
    kw = {}
    for part in filter(None, (spec or "").split(",")):
        if "=" not in part:
            raise ValueError(f"{flag} expects 'k=v,...', got {part!r}")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in keys:
            raise ValueError(
                f"unknown {flag} key {k!r}; have {', '.join(keys)}"
            )
        kw[k] = keys[k](v)
    return kw


def parse_wav_augment(spec: str) -> WavAugment:
    """Build from the CLI's ``"k=v,..."`` string (empty string -> gain_db=3
    and noise at SNR U[20, 50] dB).

    Defaults merge per knob group (gain | noise): setting a key of one
    group keeps the other group's default, and any key of a group takes
    the whole group, so ``noise_snr_max=0`` turns the noise off."""
    kw = _parse_kv(spec, "--wav_augment", {
        "gain_db": float, "noise_snr_min": float, "noise_snr_max": float,
    })
    if "gain_db" not in kw:
        kw["gain_db"] = 3.0
    if not ({"noise_snr_min", "noise_snr_max"} & kw.keys()):
        kw.update(noise_snr_min=20.0, noise_snr_max=50.0)
    return WavAugment(**kw)


def parse_spec_augment(spec: str) -> SpecAugment:
    """Build from the CLI's ``"k=v,..."`` string (empty string ->
    defaults).  Keys: freq_masks, freq_width, time_masks, time_ratio."""
    return SpecAugment(**_parse_kv(spec, "--spec_augment", {
        "freq_masks": int, "freq_width": int, "time_masks": int,
        "time_ratio": float,
    }))
