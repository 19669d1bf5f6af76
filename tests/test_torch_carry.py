"""The carried state of the layer-norm, MI and zoneout LSTMs' unidirectional
forwards (ops.ln_lstm.ln_lstm, ops.mi_lstm.mi_lstm,
ops.zoneout_lstm.zoneout_lstm, started from ``h0``, ``c0``) on the CPU:
against the JAX scan_cell from the same ``carry0`` with ``return_carry``,
over a ragged mask whose held frames repeat the state; chunks against one
call; a zero carry against none; the carry's checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.rnn import RNNLayer
from asr_study_torch.ops.ln_lstm import ln_lstm
from asr_study_torch.ops.mi_lstm import mi_lstm
from asr_study_torch.ops.zoneout_lstm import zoneout_lstm
from asr_study_torch.utils.weights import params_from_flat
from asr_study_tpu.models.rnn import RNNLayer as JaxRNNLayer
from asr_study_tpu.models.rnn import scan_cell
# the exporter's own flattening: JAX tree -> tree-path keyed arrays
from extras.export_weights import _flatten as flatten_params

TOL = dict(rtol=1e-5, atol=1e-5)
# cell kind -> (the op, the cell's keyword arguments)
CELLS = {"ln_lstm": (ln_lstm, {}),
         "mi_lstm": (mi_lstm, {}),
         "zoneout_lstm": (zoneout_lstm, dict(zoneout_h=0.2, zoneout_c=0.35))}
IDS = ["ln", "mi", "zoneout"]


def _case(kind, seed=0, t=13, b=3, f=5, h=8):
    """The JAX layer and its perturbed weights, the port layer on the same
    weights, inputs x [T, B, F], a ragged mask [T, B, 1] (row 1 holds from
    frame 6, row 2 from frame 3) and a carry (h0, c0) [B, H]."""
    kw = CELLS[kind][1]
    jlayer = JaxRNNLayer(kind, h, bidirectional=False, **kw)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.3 * rng.randn(*a.shape), a.dtype),
        jlayer.init(jax.random.PRNGKey(seed), f))
    layer = RNNLayer(kind, f, h, False, **kw)
    layer.load_state_dict(params_from_flat(flatten_params(params)))
    x = rng.randn(t, b, f).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.array([t, 6, 3])[None, :]).astype(
        np.float32)[..., None]
    carry = [(0.5 * rng.randn(b, h)).astype(np.float32) for _ in range(2)]
    return jlayer, params, layer, x, mask, carry


def _port(layer, kind, x, mask, h0=None, c0=None):
    """The op from the cell's eval-mode prepare -> (h, c) [T, B, H]."""
    with torch.no_grad():
        xp, res = layer.fw.prepare(x)
    return CELLS[kind][0](xp, mask, *res, h0=h0, c0=c0)


@pytest.mark.parametrize("kind", list(CELLS), ids=IDS)
def test_carried_forward_matches_jax_scan_cell(kind):
    """h of every real frame (scan_cell zeroes the held ones, where the op
    repeats the state) and the carry out, h and c of the last frame,
    against scan_cell(carry0=, return_carry=True) in eval mode."""
    jlayer, params, layer, x, mask, carry = _case(kind)
    xp = jlayer.cell.input_proj(params["fw"], jnp.asarray(x))
    want, (jh, jc) = scan_cell(jlayer.cell, params["fw"], xp,
                               jnp.asarray(mask),
                               carry0=tuple(map(jnp.asarray, carry)),
                               return_carry=True)
    h, c = _port(layer, kind, torch.from_numpy(x), torch.from_numpy(mask),
                 *map(torch.from_numpy, carry))
    np.testing.assert_allclose(h.numpy() * mask, np.asarray(want), **TOL)
    np.testing.assert_allclose(h[-1].numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(c[-1].numpy(), np.asarray(jc), **TOL)
    # the rows held from frame 3 end in the state of frame 2 ...
    np.testing.assert_array_equal(h[-1, 2].numpy(), h[2, 2].numpy())
    # ... and a row held from the start would keep the carry itself
    held = torch.zeros_like(torch.from_numpy(mask))
    h_held, c_held = _port(layer, kind, torch.from_numpy(x), held,
                           *map(torch.from_numpy, carry))
    np.testing.assert_array_equal(h_held[-1].numpy(), carry[0])
    np.testing.assert_array_equal(c_held[-1].numpy(), carry[1])


@pytest.mark.parametrize("kind", list(CELLS), ids=IDS)
def test_chunks_equal_one_call(kind):
    """Chunks of 5, 5 and 3 frames threading h[-1], c[-1] give one call's
    h and c bit for bit; a zero carry gives what no carry gives."""
    _, _, layer, x, mask, _ = _case(kind, seed=1)
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    h, c = _port(layer, kind, x, mask)
    carry, hs, cs = (None, None), [], []
    for lo in (0, 5, 10):
        hk, ck = _port(layer, kind, x[lo:lo + 5], mask[lo:lo + 5], *carry)
        hs.append(hk)
        cs.append(ck)
        carry = (hk[-1].contiguous(), ck[-1].contiguous())
    assert torch.equal(torch.cat(hs), h) and torch.equal(torch.cat(cs), c)
    zeros = torch.zeros(x.shape[1], layer.hidden)
    hz, cz = _port(layer, kind, x, mask, zeros, zeros.clone())
    assert torch.equal(hz, h) and torch.equal(cz, c)


@pytest.mark.parametrize("kind", list(CELLS), ids=IDS)
def test_carry_checks(kind):
    """h0 and c0 both or neither, float32 [B, H], contiguous."""
    _, _, layer, x, mask, carry = _case(kind, seed=2)
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    h0, c0 = map(torch.from_numpy, carry)
    with pytest.raises(ValueError, match="together"):
        _port(layer, kind, x, mask, h0=h0)
    with pytest.raises(ValueError, match="float32"):
        _port(layer, kind, x, mask, h0[:2], c0[:2])
    with pytest.raises(ValueError, match="float32"):
        _port(layer, kind, x, mask, h0.double(), c0)
    with pytest.raises(ValueError, match="contiguous"):
        _port(layer, kind, x, mask, h0, c0.t().contiguous().t())
