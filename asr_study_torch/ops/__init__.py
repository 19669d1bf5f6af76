"""See the package docstring of asr_study_torch.

The loss, the decoders and the metrics, exported as the JAX
``ops/__init__.py`` exports them."""

from asr_study_torch.ops.beam import beam_search_decode
from asr_study_torch.ops.ctc import blank_collapse, ctc_loss, greedy_decode
from asr_study_torch.ops.metrics import edit_distance, ler, wer

__all__ = [
    "blank_collapse",
    "ctc_loss",
    "greedy_decode",
    "beam_search_decode",
    "edit_distance",
    "ler",
    "wer",
]
