"""asr_study_torch — the PyTorch/CUDA port of ``asr_study_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; every module here mirrors its
counterpart's name and layout so the two can be read side by side.  This
package imports ``torch`` and never ``jax``, and nothing of the JAX package:
the host modules it needs from there are copies of its own
(``features/audio.py``, ``features/wav.py``, ``text/parser.py``,
``text/lm.py``, ``utils/hparams.py``, ``utils/metrics_writer.py``, ``data/corpora.py``,
``data/dataset_parser.py``, the host ``wer`` and ``cer`` of
``ops/metrics.py``).

The serving path ported so far (BASELINE config 2, and ``deep_gru``):

    pcm16, dpack or mulaw wire
                -> data/wire.unpack_audio (dpack: ops/dpack.dpack_decode,
                   csrc/dpack_onepass.cu)
                -> features (MFCC + deltas; csrc/fbank_fft.cu)
                -> models/zoo deep_blstm (csrc/bilstm_fwd.cu per layer;
                   deep_speech's 512-unit layer: csrc/lstm_wide_fwd.cu)
                   or deep_gru (csrc/gru_fwd.cu per layer)
                -> ops/ctc.greedy_decode, or ops/beam.beam_search_decode
                   (csrc/ctc_beam.cu, a CTA per utterance; a char n-gram
                   LM from cli/train_lm fused with --lm)
                -> cli/predict.py --on_device

and the training path (BASELINE config 3, and ``deep_gru``):

    cli/make_dataset (data/corpora -> a JSON-lines manifest)
        -> cli/train: data/generator.flow_from_json (host features)
        -> train/loop.fit -> train/trainer.train_step:
        deep_blstm (ops/bilstm.BiLSTMFunction: csrc/bilstm_fwd.cu forward,
        csrc/bilstm_bwd.cu backward; at H=512 csrc/lstm_wide_fwd.cu and
        csrc/lstm_wide_bwd.cu) or deep_gru (ops/gru.BiGRUFunction
        and GRUFunction: csrc/gru_fwd.cu forward, csrc/gru_bwd.cu
        backward) -> ops/ctc.ctc_loss (CTCNLL: csrc/ctc_warp.cu alpha
        forward, beta backward) -> [--num_devices N: parallel/dp, one
        flat all-reduce of the gradients over N ranks] -> clip -> Adam
                -> train/checkpoint.CheckpointManager
        -> cli/eval (forward, CTC loss, greedy or beam decode, blank
           collapse; CER and WER)

Each hand-written CUDA kernel is compiled with ``nvcc`` at first use
(``_build.py``) and has a plain PyTorch version beside it, which runs for
CPU tensors and is what the kernel is checked against on the card.
"""

__version__ = "0.1.0"
