"""asr_study_torch — the PyTorch/CUDA port of ``asr_study_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; every module here mirrors its
counterpart's name and layout so the two can be read side by side.  This
package imports ``torch`` and never ``jax``, and nothing of the JAX package:
the host modules it needs from there are copies of its own
(``features/audio.py``, ``features/wav.py``, ``text/parser.py``,
``utils/hparams.py``, ``utils/metrics_writer.py``).

The serving path ported so far (BASELINE config 2, and ``deep_gru``):

    pcm16, dpack or mulaw wire
                -> data/wire.unpack_audio (dpack: ops/dpack.dpack_decode,
                   csrc/dpack.cu)
                -> features (MFCC + deltas; csrc/fbank.cu)
                -> models/zoo deep_blstm (csrc/bilstm_fwd.cu per layer)
                   or deep_gru (csrc/gru_fwd.cu per layer)
                -> ops/ctc.greedy_decode
                -> cli/predict.py --on_device

and the training path (BASELINE config 3, and ``deep_gru``):

    data/generator batches -> train/loop.fit -> train/trainer.train_step:
        deep_blstm (ops/bilstm.BiLSTMFunction: csrc/bilstm_fwd.cu forward,
        csrc/bilstm_bwd.cu backward) or deep_gru (ops/gru.BiGRUFunction
        and GRUFunction: csrc/gru_fwd.cu forward, csrc/gru_bwd.cu
        backward) -> ops/ctc.ctc_loss (CTCNLL: csrc/ctc.cu alpha forward,
        beta backward) -> clip -> Adam
                -> train/checkpoint.CheckpointManager

Each hand-written CUDA kernel is compiled with ``nvcc`` at first use
(``_build.py``) and has a plain PyTorch version beside it, which runs for
CPU tensors and is what the kernel is checked against on the card.
"""

__version__ = "0.1.0"
