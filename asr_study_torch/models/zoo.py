"""Acoustic model and named constructors (port of
``asr_study_tpu/models/zoo.py``).

``AcousticModel``: features [B, T, F] -> CTC logits [B, T, V+1] with the
blank last.  Batch-major at the API, time-major inside, the frame mask
made from the lengths.  The port keeps its own name -> constructor table
(``MODELS``); it never touches the JAX package's registry.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from asr_study_torch.models.nn import dense_apply, dense_init
from asr_study_torch.models.rnn import StackedRNN
from asr_study_torch.utils.hparams import HParams


class AcousticModel(nn.Module):
    """StackedRNN -> Dense(num_classes + 1).  Parameters under ``rnn`` and
    ``out``, as in the JAX tree."""

    def __init__(self, num_classes: int, rnn: StackedRNN,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.num_classes = num_classes       # real labels; blank appended
        self.rnn = rnn
        self.out = nn.ParameterDict(
            dense_init(rnn.output_dim, self.vocab_size, generator, device))

    @property
    def input_dim(self) -> int:
        return self.rnn.input_dim

    @property
    def vocab_size(self) -> int:
        return self.num_classes + 1

    @property
    def blank_id(self) -> int:
        return self.num_classes

    def forward(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """inputs [B, T, F], input_lengths [B] -> logits [B, T, V+1].

        ``train`` turns the stack's dropout on, drawn from ``generator``
        (a ``torch.Generator`` on the inputs' device)."""
        x = inputs.transpose(0, 1)                               # [T, B, F]
        t_steps = x.shape[0]
        mask = (torch.arange(t_steps, device=x.device)[:, None]
                < input_lengths[None, :]).to(x.dtype)[..., None]  # [T, B, 1]
        h = self.rnn(x, mask, train, generator)
        return dense_apply(self.out, h).transpose(0, 1)


def _hp(params, **defaults) -> HParams:
    hp = HParams(**defaults)
    if isinstance(params, HParams):
        params = params.to_dict()
    if isinstance(params, dict):
        for k, v in params.items():
            hp.set(k, v)
    elif isinstance(params, str):
        hp.parse(params)
    return hp


def _stacked(hp: HParams, input_dim: int, cell_kind: str, generator,
             device) -> StackedRNN:
    return StackedRNN(
        input_dim,
        cell_kind=cell_kind,
        hidden=hp.num_hiddens,
        num_layers=hp.num_layers,
        bidirectional=hp.bidirectional,
        dropout=hp.dropout,
        skip=hp.get("skip", "none"),
        generator=generator,
        device=device,
    )


def graves2006(params=None, num_classes: int = 27, input_dim: int = 39,
               generator: Optional[torch.Generator] = None,
               device: torch.device | str | None = None) -> AcousticModel:
    """Single-layer BLSTM with 100 units (Graves et al. 2006)."""
    hp = _hp(params, num_hiddens=100, num_layers=1, bidirectional=True,
             dropout=0.0)
    return AcousticModel(
        num_classes, _stacked(hp, input_dim, "lstm", generator, device),
        generator, device)


def deep_blstm(params=None, num_classes: int = 27, input_dim: int = 39,
               generator: Optional[torch.Generator] = None,
               device: torch.device | str | None = None) -> AcousticModel:
    """Deep bidirectional LSTM stack (BASELINE configs 2 and 3)."""
    hp = _hp(params, num_hiddens=256, num_layers=3, bidirectional=True,
             dropout=0.2)
    return AcousticModel(
        num_classes, _stacked(hp, input_dim, "lstm", generator, device),
        generator, device)


def deep_gru(params=None, num_classes: int = 27, input_dim: int = 39,
             generator: Optional[torch.Generator] = None,
             device: torch.device | str | None = None) -> AcousticModel:
    """Deep (B)GRU stack (the reference's GRU configs);
    ``bidirectional=false`` gives the forward-only model."""
    hp = _hp(params, num_hiddens=256, num_layers=3, bidirectional=True,
             dropout=0.2)
    return AcousticModel(
        num_classes, _stacked(hp, input_dim, "gru", generator, device),
        generator, device)


MODELS = {"graves2006": graves2006, "deep_blstm": deep_blstm,
          "deep_gru": deep_gru}

# constructors of the JAX zoo that the port does not have yet
_NOT_PORTED = ("ln_blstm", "zoneout_blstm", "mi_blstm",
               "highway_blstm", "residual_blstm", "deep_speech")


def build_model(name: str, params=None, num_classes: int = 27,
                input_dim: int = 39,
                generator: Optional[torch.Generator] = None,
                device: torch.device | str | None = None) -> AcousticModel:
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP queue A item 1)")
    if key not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{', '.join(sorted(MODELS))}")
    return MODELS[key](params, num_classes=num_classes, input_dim=input_dim,
                       generator=generator, device=device)
