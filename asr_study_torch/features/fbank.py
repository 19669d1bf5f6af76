"""The fbank kernel (``csrc/fbank.cu``) and the featurizer that uses it
(port of ``asr_study_tpu/features/pallas_fbank.py``).

:func:`fbank` runs the spectral core of the feature chain (framing, window,
DFT, power, mel, log, DCT, lifter, energy) in one launch per batch.  For a
tensor on the CPU it takes the plain version, ``device.spectral_plain``;
for a CUDA tensor it launches the kernel or raises.  Pre-emphasis,
centering, deltas and CMVN stay plain torch around it, as they stay XLA
around the Pallas kernel in JAX.
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


def fbank(chain: SpectralChain, pre: torch.Tensor, t_out: int) -> torch.Tensor:
    """Prepared signal [B, N] float32 -> base features [B, t_out, F].

    F is ``chain.num_out``: 13 cepstra for MFCC (c0 replaced by the log
    energy when ``append_energy``), the log-mel channels (plus an energy
    column) for logfbank, the linear mel channels for fbank."""
    if pre.dtype != torch.float32 or pre.dim() != 2:
        raise ValueError(f"fbank: pre must be float32 [B, N], got "
                         f"{pre.dtype} {tuple(pre.shape)}")
    if t_out < 1:
        raise ValueError(f"fbank: t_out must be >= 1, got {t_out}")
    tables = (chain.window, chain.cos, chain.sin, chain.mel, chain.dct,
              chain.lift)
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
    if not all(tab.is_contiguous() for tab in tables):
        raise ValueError("fbank: operator tables must be contiguous")

    batch = pre.shape[0]
    need = (t_out - 1) * chain.frame_step + chain.frame_len
    if need > pre.shape[1]:
        pre = torch.nn.functional.pad(pre, (0, need - pre.shape[1]))
    pre = pre.contiguous()
    n_bins, n_mel = chain.mel.shape
    n_cep = chain.dct.shape[1]
    if chain.cos.shape != (chain.frame_len, n_bins) or \
            chain.sin.shape != (chain.frame_len, n_bins):
        raise ValueError("fbank: DFT tables must be [frame_len, n_bins]")
    out = torch.empty((batch, t_out, chain.num_out), dtype=torch.float32,
                      device=pre.device)
    if batch == 0:
        return out
    with torch.cuda.device(pre.device):
        err = _build.lib().asr_fbank(
            pre.data_ptr(), pre.shape[1], *(t.data_ptr() for t in tables),
            out.data_ptr(), batch, t_out, chain.frame_len,
            chain.frame_step, n_bins, n_mel, n_cep, chain.num_out,
            1.0 / chain.nfft, chain.floor, _MODES[chain.kind],
            int(chain.append_energy),
            torch.cuda.current_stream(pre.device).cuda_stream,
        )
    _build.check(err, "fbank")
    fbank.launches += 1
    return out


fbank.launches = 0


class KernelFeaturizer(DeviceFeaturizer):
    """``DeviceFeaturizer`` whose spectral core goes through :func:`fbank`.

    The 'raw' kind has no spectral chain and runs as the plain one."""

    def _spectral(self, pre: torch.Tensor, t_out: int) -> torch.Tensor:
        return fbank(self.chain, pre, t_out)
