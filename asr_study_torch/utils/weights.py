"""Weight bridge: the JAX package's parameters into the port's modules.

The JAX parameters are a nested dict; ``extras/export_weights.py`` flattens
it into one ``.npz`` keyed by tree path (``rnn/layers/0/rnn/fw/wx``,
``rnn/layers/0/rnn/fw/wh``, ``rnn/layers/0/rnn/fw/b``, ``out/w``,
``out/b``) with a JSON ``__meta__`` entry.  The port's modules are laid out
so that their ``state_dict`` keys are those paths with ``/`` read as ``.``,
and the tensors keep JAX's layouts: ``wx`` [F, G*H], ``wh`` [H, G*H] and
``b`` [G*H] with G gate blocks (LSTM: 4, gate order i, f, g, o, the forget
bias 1 in ``b``; GRU: 3, gate order r, z, n), and ``out/w`` [D*H, V+1] for
D directions (a unidirectional layer has ``fw`` only).  A layer-norm LSTM
cell adds its LayerNorm gains and biases under the cell's path:
``rnn/layers/<i>/rnn/fw/ln_x/g`` and ``.../ln_x/b`` [4H] (the input side,
one LayerNorm per gate block), ``ln_h/g`` and ``ln_h/b`` [4H] (the
recurrent side, the same) and ``ln_c/g`` and ``ln_c/b`` [H] (the cell
state).

Dense layers are ``w`` [in, out] and ``b`` [out] under their own paths:
the Deep Speech front end ``front/<i>/w`` and ``front/<i>/b``, and the skip
parameters of a residual or highway stack, ``rnn/layers/<i>/proj/w`` (only
where layer i changes the width) and ``rnn/layers/<i>/gate/w`` (every
highway layer).
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch

META_KEY = "__meta__"


def params_from_flat(flat: Mapping[str, np.ndarray],
                     device: torch.device | str | None = None
                     ) -> dict[str, torch.Tensor]:
    """Tree-path keyed arrays -> a ``state_dict`` for the port's modules.

    Pass the result to ``model.load_state_dict`` (strict: a key the model
    lacks, or one it has and the file lacks, raises there)."""
    out = {}
    for key, arr in flat.items():
        if key == META_KEY:
            continue
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            raise ValueError(
                f"{key}: the port runs float32 weights, got {arr.dtype}"
            )
        out[key.replace("/", ".")] = torch.tensor(arr, device=device)
    return out


def flat_from_params(state: Mapping[str, torch.Tensor]
                     ) -> dict[str, np.ndarray]:
    """The inverse: a port ``state_dict`` -> tree-path keyed arrays."""
    return {
        key.replace(".", "/"): t.detach().cpu().numpy()
        for key, t in state.items()
    }


def load_npz(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Read an ``export_weights`` artifact -> (flat arrays, meta).

    ``meta`` holds ``model``, ``params``, ``num_feats``, ``num_classes``,
    ``vocab`` and ``blank_id`` as the exporter wrote them."""
    with np.load(path) as z:
        if META_KEY not in z.files:
            raise ValueError(f"{path}: no {META_KEY} entry; not an "
                             "extras/export_weights.py artifact")
        meta = json.loads(str(z[META_KEY]))
        flat = {k: z[k] for k in z.files if k != META_KEY}
    return flat, meta
