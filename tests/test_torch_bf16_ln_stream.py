"""bf16 compute of the layer-norm LSTM at the batches that send it to its
stream design (``train --bf16 --batch_size 64 --model ln_blstm``: past the
cluster design's budget, B > 48 in two directions and B > 96 in one) on
the CPU: ``Trainer(compute_dtype=torch.bfloat16)`` steps of one-layer
ln_blstm at B=50 in two directions and B=97 in one, the plain twins of
the stream kernels' bfloat16-weight forms, against the JAX
``Trainer(compute_dtype=jnp.bfloat16)`` on its Pallas route.  The
Functions at the stream design's shapes, and every case at the cluster
design's: ``tests/test_torch_bf16_ln.py``, whose tolerances these tests
share (loss rel 1e-3, every gradient within 1e-2 of its max abs)."""

import pytest

from asr_study_torch.ops import ln_lstm as LN
from tests.test_torch_bf16_ln import check_ln_train_step

# (hparams, batch): one layer of H=8 on the T=17 batch, at a batch that
# sends the recurrence to the stream design
LN_STREAM_STEP_CASES = {
    "ln_blstm_b50": ("num_hiddens=8,num_layers=1,dropout=0.0", 50),
    "ln_blstm_uni_b97": ("num_hiddens=8,num_layers=1,dropout=0.0,"
                         "bidirectional=false", 97),
}


@pytest.mark.parametrize("case", list(LN_STREAM_STEP_CASES))
def test_bf16_ln_stream_train_step_matches_jax(monkeypatch, case):
    """tests/test_torch_bf16_ln.py's check_ln_train_step at a batch of the
    stream design: the loss within LOSS_RTOL, every gradient within
    GRAD_FRAC of its max, float32 masters and optimizer state."""
    hp, b = LN_STREAM_STEP_CASES[case]
    ndir = 1 if "bidirectional=false" in hp else 2
    assert LN.ln_geometry(8, b, ndir).design == "stream"
    check_ln_train_step(monkeypatch, hp, b=b)
