"""bf16 compute of the zoneout and MI LSTMs at the shapes that send them to
their stream designs (``train --bf16 --batch_size 64 --model zoneout_blstm
| mi_blstm``: H > 256, or a batch past the cluster design's budget, B > 48
in two directions and B > 96 in one) on the CPU, held against the JAX
package: ``BiZoneoutLSTMFunction`` / ``ZoneoutLSTMFunction`` and
``BiMILSTMFunction`` / ``MILSTMFunction`` with a bfloat16 ``wh`` (the
plain twins of the stream kernels' bfloat16-weight forms) against
``pallas_bi_zoneout_lstm`` / ``pallas_zoneout_lstm`` and
``pallas_bi_mi_lstm`` / ``pallas_mi_lstm`` with one in interpret mode, and
``Trainer(compute_dtype=torch.bfloat16)`` steps of zoneout_blstm and
mi_blstm at B=50 in two directions and zoneout_blstm at B=97 in one
against the JAX ``Trainer(compute_dtype=jnp.bfloat16)`` on its Pallas
route.  The cluster design's shapes: ``tests/test_torch_bf16_zoneout_mi.py``,
whose tolerances these tests share."""

import numpy as np
import pytest

from asr_study_torch.ops import mi_lstm as M
from asr_study_torch.ops import zoneout_lstm as Z
from tests.test_torch_bf16_zoneout_mi import (check_mi_parity,
                                              check_train_step,
                                              check_zoneout_parity)

T_STEPS = 2


def _inputs(cell, seed, t, b, h):
    """What tests/test_torch_bf16_zoneout_mi.py's _zo_inputs (``cell``
    "zoneout") or _mi_inputs ("mi") give, for any B: the mask holds the
    last row after its first frame."""
    rng = np.random.RandomState(seed)
    xp_f, xp_b = (rng.randn(t, b, 4 * h).astype(np.float32)
                  for _ in range(2))
    lengths = np.full(b, t)
    lengths[-1] = 1
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(
        np.float32)[..., None]
    wh_f, wh_b = ((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
                  for _ in range(2))
    dh = tuple(rng.randn(t, b, h).astype(np.float32) for _ in range(2))
    if cell == "zoneout":
        z = [(rng.rand(t, b, h) < 0.8).astype(np.float32) for _ in range(4)]
        return (xp_f, xp_b, mask, *z, wh_f, wh_b), dh
    vecs = [(c + 0.3 * rng.randn(4 * h)).astype(np.float32)
            for c in (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0)]
    return (xp_f, xp_b, mask, wh_f, wh_b, *vecs), dh


def _counts(cell):
    mod = Z if cell == "zoneout" else M
    name = "zoneout_lstm" if cell == "zoneout" else "mi_lstm"
    ops = [getattr(mod, f"{p}{name}{s}") for p in ("bi_", "")
           for s in ("", "_bwd")]
    return [(op.launches, dict(op.by_design)) for op in ops]


@pytest.mark.parametrize("cell", ["zoneout", "mi"])
@pytest.mark.parametrize("hidden,batch,ndir", [(300, 2, 1), (512, 3, 2),
                                               (100, 49, 2)])
def test_zoneout_mi_stream_design_refuses_bf16(cell, hidden, batch, ndir):
    """At a shape that zoneout_geometry / mi_geometry sends to the stream
    design (H > 256, or a batch past the cluster budget) a bfloat16 call
    runs, forward and backward: on the CPU the plain twin of the stream
    design's bfloat16 forms, no launch counted, nothing refused and no
    float32 form taken.  h, dxp and dwh (and MI's vector gradients) of the
    Functions against the JAX Pallas ops with a bfloat16 wh in interpret
    mode, at T=2 with a held frame."""
    geometry = Z.zoneout_geometry if cell == "zoneout" else M.mi_geometry
    assert geometry(hidden, batch, ndir).design == "stream"
    args, dh = _inputs(cell, hidden + batch + ndir, T_STEPS, batch, hidden)
    before = _counts(cell)
    parity = check_zoneout_parity if cell == "zoneout" else check_mi_parity
    parity(ndir, hidden, args, dh)
    assert _counts(cell) == before


# (model, hparams, batch): one layer of H=8 on the T=12 batch, at a batch
# that sends the recurrence to the stream design (B=50 in two directions,
# B=97 in one); zoneout at rate 0
ZM_STREAM_STEP_CASES = {
    "zoneout_blstm_b50": ("zoneout_blstm", "num_hiddens=8,num_layers=1,"
                          "dropout=0.0,zoneout_h=0.0,zoneout_c=0.0", 50),
    "mi_blstm_b50": ("mi_blstm", "num_hiddens=8,num_layers=1,dropout=0.0",
                     50),
    "zoneout_blstm_uni_b97": ("zoneout_blstm", "num_hiddens=8,num_layers=1,"
                              "dropout=0.0,zoneout_h=0.0,zoneout_c=0.0,"
                              "bidirectional=false", 97),
}


@pytest.mark.parametrize("case", list(ZM_STREAM_STEP_CASES))
def test_bf16_zoneout_mi_stream_train_step_matches_jax(monkeypatch, case):
    """tests/test_torch_bf16_zoneout_mi.py's check_train_step at a batch of
    the stream design: the loss within LOSS_RTOL, every gradient within
    GRAD_FRAC of its max, float32 masters and optimizer state."""
    model, hp, b = ZM_STREAM_STEP_CASES[case]
    geometry = Z.zoneout_geometry if model == "zoneout_blstm" else \
        M.mi_geometry
    ndir = 1 if "bidirectional=false" in hp else 2
    assert geometry(8, b, ndir).design == "stream"
    check_train_step(monkeypatch, model, hp, b=b)
