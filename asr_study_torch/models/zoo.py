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
from asr_study_torch.models.nn import dropout as dropout_fn
from asr_study_torch.models.rnn import StackedRNN
from asr_study_torch.utils.hparams import HParams


class AcousticModel(nn.Module):
    """[Dense front end with clipped ReLU (Deep Speech 1)] -> StackedRNN ->
    Dense(num_classes + 1).  Parameters under ``front``, ``rnn`` and
    ``out``, as in the JAX tree.

    The front end is ``input_layers`` dense layers of ``input_dense`` units
    on the features (``input_dim`` wide): ``clip(relu(x @ w + b), 0,
    relu_clip)``, each followed by dropout at ``input_dropout`` in train
    mode, then ``x *= mask``.  Without it (``input_layers`` 0) the stack
    takes the features."""

    def __init__(self, num_classes: int, rnn: StackedRNN,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None,
                 input_dim: Optional[int] = None, input_dense: int = 0,
                 input_layers: int = 0, input_dropout: float = 0.0,
                 relu_clip: float = 20.0):
        super().__init__()
        self.num_classes = num_classes       # real labels; blank appended
        self.input_dropout = input_dropout
        self.relu_clip = relu_clip
        self._input_dim = rnn.input_dim
        front = []
        if input_layers:
            if input_dim is None or rnn.input_dim != input_dense:
                raise ValueError(
                    f"a front end of {input_layers} x {input_dense} units "
                    f"needs input_dim and a stack {input_dense} wide (got "
                    f"input_dim={input_dim}, stack {rnn.input_dim})")
            self._input_dim = dim = input_dim
            for _ in range(input_layers):
                front.append(nn.ParameterDict(
                    dense_init(dim, input_dense, generator, device)))
                dim = input_dense
        self.front = nn.ModuleList(front)
        self.rnn = rnn
        self.out = nn.ParameterDict(
            dense_init(rnn.output_dim, self.vocab_size, generator, device))

    @property
    def input_dim(self) -> int:
        return self._input_dim

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

        ``train`` turns the front end's and the stack's dropout on, drawn
        from ``generator`` (a ``torch.Generator`` on the inputs' device),
        the front end's first."""
        x = inputs.transpose(0, 1)                               # [T, B, F]
        t_steps = x.shape[0]
        mask = (torch.arange(t_steps, device=x.device)[:, None]
                < input_lengths[None, :]).to(x.dtype)[..., None]  # [T, B, 1]
        if len(self.front):
            for p in self.front:
                x = torch.clamp(torch.relu(dense_apply(p, x)), 0.0,
                                self.relu_clip)
                x = dropout_fn(x, self.input_dropout, train, generator)
            x = x * mask
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


def ln_blstm(params=None, num_classes: int = 27, input_dim: int = 39,
             generator: Optional[torch.Generator] = None,
             device: torch.device | str | None = None) -> AcousticModel:
    """Layer-norm BLSTM stack (the reference's LN variant);
    ``bidirectional=false`` gives the forward-only model."""
    hp = _hp(params, num_hiddens=256, num_layers=3, bidirectional=True,
             dropout=0.2)
    return AcousticModel(
        num_classes, _stacked(hp, input_dim, "ln_lstm", generator, device),
        generator, device)


def highway_blstm(params=None, num_classes: int = 27, input_dim: int = 39,
                  generator: Optional[torch.Generator] = None,
                  device: torch.device | str | None = None
                  ) -> AcousticModel:
    """BLSTM stack with highway connections between recurrent layers
    (the reference's highway variant)."""
    hp = _hp(params, num_hiddens=256, num_layers=5, bidirectional=True,
             dropout=0.2, skip="highway")
    return AcousticModel(
        num_classes, _stacked(hp, input_dim, "lstm", generator, device),
        generator, device)


def residual_blstm(params=None, num_classes: int = 27, input_dim: int = 39,
                   generator: Optional[torch.Generator] = None,
                   device: torch.device | str | None = None
                   ) -> AcousticModel:
    """BLSTM stack with residual connections between recurrent layers
    (the reference's residual variant)."""
    hp = _hp(params, num_hiddens=256, num_layers=5, bidirectional=True,
             dropout=0.2, skip="residual")
    return AcousticModel(
        num_classes, _stacked(hp, input_dim, "lstm", generator, device),
        generator, device)


def deep_speech(params=None, num_classes: int = 27, input_dim: int = 39,
                generator: Optional[torch.Generator] = None,
                device: torch.device | str | None = None) -> AcousticModel:
    """Deep-Speech-1-style model: ``input_layers`` clipped-ReLU dense
    layers of ``input_dense`` units, one bidirectional recurrent layer,
    dense output."""
    hp = _hp(params, num_hiddens=512, num_layers=1, bidirectional=True,
             dropout=0.1, input_dense=512, input_layers=3, input_dropout=0.1)
    rnn_in = hp.input_dense if hp.input_layers else input_dim
    return AcousticModel(
        num_classes, _stacked(hp, rnn_in, "lstm", generator, device),
        generator, device, input_dim=input_dim, input_dense=hp.input_dense,
        input_layers=hp.input_layers, input_dropout=hp.input_dropout)


MODELS = {"graves2006": graves2006, "deep_blstm": deep_blstm,
          "deep_gru": deep_gru, "ln_blstm": ln_blstm,
          "highway_blstm": highway_blstm, "residual_blstm": residual_blstm,
          "deep_speech": deep_speech}

# constructors of the JAX zoo that the port does not have yet -> their
# cells' kernels, ROADMAP queue B items
_NOT_PORTED = {"zoneout_blstm": "B9-B10", "mi_blstm": "B11-B12"}


def build_model(name: str, params=None, num_classes: int = 27,
                input_dim: int = 39,
                generator: Optional[torch.Generator] = None,
                device: torch.device | str | None = None) -> AcousticModel:
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP queue A item 1; its "
            f"kernels are queue B items {_NOT_PORTED[key]})")
    if key not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{', '.join(sorted(MODELS))}")
    return MODELS[key](params, num_classes=num_classes, input_dim=input_dim,
                       generator=generator, device=device)
