"""Which featurizer a device gets (port of
``asr_study_tpu/features/select.py``).

The kernel featurizer for a CUDA device, the plain one for the CPU.  There
is no probe and no fallback: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from asr_study_torch.features.device import DeviceFeaturizer
from asr_study_torch.features.fbank import KernelFeaturizer


def featurizer(kind: str, device: torch.device | str,
               **kw) -> DeviceFeaturizer:
    device = torch.device(device)
    cls = KernelFeaturizer if device.type == "cuda" else DeviceFeaturizer
    return cls(kind=kind, device=device, **kw)
