"""The fbank kernels and the featurizer that uses them (port of
``asr_study_tpu/features/pallas_fbank.py``).

:func:`fbank` runs the spectral core of the feature chain (framing, window,
spectrum, power, mel, log, DCT, lifter, energy) in one launch per batch.
Two kernel designs compute it; :func:`fbank_design` picks one from the
sizes.  The FFT design (``csrc/fbank_fft.cu``: a warp a frame, a real FFT
through a half-length complex FFT, each mel filter over its band) takes
nfft in {256, 512, 1024, 2048} with frame_len <= nfft and a CTA that fits
in shared memory, which every zoo featurizer meets; the DFT design
(``csrc/fbank.cu``: the frames against [frame_len, nfft/2+1] cos and sin
tables) takes the rest.  For a tensor on
the CPU the wrapper takes the plain version, ``device.spectral_plain``; for
a CUDA tensor it launches a kernel or raises.  Pre-emphasis, centering,
deltas and CMVN stay plain torch around it, as they stay XLA around the
Pallas kernel in JAX.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.features.device import (
    DeviceFeaturizer,
    SpectralChain,
    spectral_plain,
)

_MODES = {"mfcc": 0, "logfbank": 1, "fbank": 2}

# the FFT design's transform sizes; its CTA shape, warps a CTA and frames a
# tile (csrc/fbank_fft.cu's kWarps and kTile, mirrored for fft_smem); the
# dynamic shared memory a CTA may opt in to on sm_90 (227 KB)
FFT_SIZES = (256, 512, 1024, 2048)
_FFT_WARPS = 8
_FFT_TILE = 16
SMEM_LIMIT = 227 * 1024


def fft_smem(chain: SpectralChain) -> int:
    """Dynamic shared memory of a CTA of the FFT design for ``chain``, in
    bytes: the ``Layout`` of csrc/fbank_fft.cu (each part rounded to 4
    floats; the warps' FFT rows later hold the mel values and the staged
    output)."""
    def r4(n):
        return (n + 3) & ~3
    m = chain.nfft // 2
    n_mel, n_cep = chain.dct.shape
    fixed = (r4((_FFT_TILE - 1) * chain.frame_step + chain.frame_len + 4)
             + 2 * m + r4(chain.frame_len) + r4(chain.mel_packed.numel())
             + r4(n_mel * n_cep) + r4(n_cep) + r4(3 * n_mel) + r4(_FFT_TILE)
             + r4(_FFT_TILE * (m + 1)))
    return 4 * (fixed + max(_FFT_WARPS * 2 * (m + m // 8),
                            r4(_FFT_TILE * (n_mel | 1))
                            + r4(_FFT_TILE * chain.num_out)))


def fbank_design(nfft: int, frame_len: int, smem_bytes: int) -> str:
    """The kernel design for a chain of ``nfft`` and ``frame_len`` whose
    FFT-design CTA needs ``smem_bytes`` (:func:`fft_smem`): ``"fft"``
    (csrc/fbank_fft.cu) for nfft in FFT_SIZES, frame_len <= nfft and
    smem_bytes <= SMEM_LIMIT, ``"dft"`` (csrc/fbank.cu) otherwise."""
    return ("fft" if nfft in FFT_SIZES and frame_len <= nfft
            and smem_bytes <= SMEM_LIMIT else "dft")


def chain_design(chain: SpectralChain) -> str:
    """:func:`fbank_design` of ``chain``: the design the wrapper runs."""
    return fbank_design(chain.nfft, chain.frame_len, fft_smem(chain))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_fft(chain: SpectralChain, pre: torch.Tensor, t_out: int,
               out: torch.Tensor) -> None:
    """One launch of the FFT design into ``out`` [B, t_out, num_out] (the
    wrapper's arguments already checked); frames past ``pre``'s rows read
    zeros."""
    n_mel, n_cep = chain.dct.shape
    with torch.cuda.device(pre.device):
        err = _build.lib().asr_fbank_fft(
            pre.data_ptr(), pre.shape[1], chain.window.data_ptr(),
            chain.twiddle.data_ptr(), chain.mel_packed.data_ptr(),
            chain.mel_packed.shape[0], chain.mel_bands.data_ptr(),
            chain.dct.data_ptr(), chain.lift.data_ptr(), out.data_ptr(),
            pre.shape[0], t_out, chain.frame_len, chain.frame_step,
            chain.nfft, n_mel, n_cep, chain.num_out, chain.floor,
            _MODES[chain.kind], int(chain.append_energy), _stream(pre))
    _build.check(err, "fbank (fft design)")


def launch_dft(chain: SpectralChain, pre: torch.Tensor, t_out: int,
               out: torch.Tensor) -> None:
    """One launch of the DFT design into ``out``; ``pre`` must hold every
    sample of the t_out frames."""
    n_bins, n_mel = chain.mel.shape
    with torch.cuda.device(pre.device):
        err = _build.lib().asr_fbank(
            pre.data_ptr(), pre.shape[1], chain.window.data_ptr(),
            chain.cos.data_ptr(), chain.sin.data_ptr(), chain.mel.data_ptr(),
            chain.dct.data_ptr(), chain.lift.data_ptr(), out.data_ptr(),
            pre.shape[0], t_out, chain.frame_len, chain.frame_step, n_bins,
            n_mel, chain.dct.shape[1], chain.num_out, 1.0 / chain.nfft,
            chain.floor, _MODES[chain.kind], int(chain.append_energy),
            _stream(pre))
    _build.check(err, "fbank (dft design)")


def fbank(chain: SpectralChain, pre: torch.Tensor, t_out: int
          ) -> torch.Tensor:
    """Prepared signal [B, N] float32 -> base features [B, t_out, F].

    F is ``chain.num_out``: 13 cepstra for MFCC (c0 replaced by the log
    energy when ``append_energy``), the log-mel channels (plus an energy
    column) for logfbank, the linear mel channels for fbank.  On the card
    the design is :func:`chain_design`'s, counted in ``fbank.by_design``."""
    if pre.dtype != torch.float32 or pre.dim() != 2:
        raise ValueError(f"fbank: pre must be float32 [B, N], got "
                         f"{pre.dtype} {tuple(pre.shape)}")
    if t_out < 1:
        raise ValueError(f"fbank: t_out must be >= 1, got {t_out}")
    tables = (chain.window, chain.cos, chain.sin, chain.mel, chain.dct,
              chain.lift, chain.twiddle, chain.mel_packed)
    for tab in tables:
        if tab.device != pre.device or tab.dtype != torch.float32:
            raise ValueError(
                f"fbank: tables must be float32 on {pre.device}, got "
                f"{tab.dtype} on {tab.device}")
    if pre.device.type == "cpu":
        return spectral_plain(chain, pre, t_out)
    if pre.device.type != "cuda":
        raise ValueError(f"fbank: no kernel for device {pre.device}")
    if pre.requires_grad and torch.is_grad_enabled():
        raise ValueError("fbank: the kernel has no backward")
    bands = chain.mel_bands
    if bands.device != pre.device or bands.dtype != torch.int32 or \
            bands.shape != (chain.mel.shape[1], 2):
        raise ValueError("fbank: mel_bands must be int32 [n_mel, 2] on "
                         f"{pre.device}")
    if not all(tab.is_contiguous() for tab in (*tables, bands)):
        raise ValueError("fbank: operator tables must be contiguous")
    n_bins = chain.mel.shape[0]
    if chain.cos.shape != (chain.frame_len, n_bins) or \
            chain.sin.shape != (chain.frame_len, n_bins):
        raise ValueError("fbank: DFT tables must be [frame_len, n_bins]")
    if chain.twiddle.shape != (chain.nfft, 2):
        raise ValueError("fbank: the twiddle table must be [nfft, 2]")

    out = torch.empty((pre.shape[0], t_out, chain.num_out),
                      dtype=torch.float32, device=pre.device)
    if pre.shape[0] == 0:
        return out
    design = chain_design(chain)
    if design == "fft":
        launch_fft(chain, pre.contiguous(), t_out, out)
    else:
        need = (t_out - 1) * chain.frame_step + chain.frame_len
        if need > pre.shape[1]:
            pre = torch.nn.functional.pad(pre, (0, need - pre.shape[1]))
        launch_dft(chain, pre.contiguous(), t_out, out)
    fbank.launches += 1
    fbank.by_design[design] += 1
    return out


fbank.launches = 0
fbank.by_design = {"fft": 0, "dft": 0}


class KernelFeaturizer(DeviceFeaturizer):
    """``DeviceFeaturizer`` whose spectral core goes through :func:`fbank`.

    The 'raw' kind has no spectral chain and runs as the plain one."""

    def _spectral(self, pre: torch.Tensor, t_out: int) -> torch.Tensor:
        return fbank(self.chain, pre, t_out)
