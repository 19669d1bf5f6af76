"""Streaming (chunked) inference: unbounded-length transcription at bounded
memory and bounded latency (port of ``asr_study_tpu/streaming.py``).

- ``_DeltaStream``, ``StreamingFeaturizer`` and ``GreedyStream`` are copies
  of the JAX package's (NumPy on the host, built on the port's own
  ``features/audio.py``): chunked features equal the full-utterance oracle
  for every chunking, and the greedy collapse carries the previous argmax
  across chunks (on the device, the argmax is taken there and only the
  label ids cross to the host).
- ``AcousticModel.apply_streaming`` carries the recurrent state across
  chunks (unidirectional models of every cell kind: one launch of the
  layer's forward kernel a chunk on a CUDA device, started from the
  carry).
- ``BeamStream`` carries the prefix beam's state across chunks
  (``ops.beam.beam_stream_chunk``: one launch of the beam kernel a chunk on
  a CUDA device) and splices each chunk's prefixes onto the carried ones
  on the host.

``StreamingRecognizer`` glues them together behind push()/finish() for one
stream, ``MultiStreamRecognizer`` runs N streams as the batch of one model
step a tick.  Each holds one chunk shape (``chunk_frames``), pads the
ragged tail and masks it.  On a CUDA device the carries and the beam state
stay on the card between chunks; only each chunk's label ids (greedy) or
its beam prefixes cross to the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from asr_study_torch.features import audio
from asr_study_torch.ops import beam as beam_ops


class _DeltaStream:
    """Streaming regression delta (audio.delta semantics: ±n window with
    edge replication at the TRUE sequence boundaries).  push(rows, final)
    emits the delta rows whose windows are complete."""

    def __init__(self, n: int = 2):
        self.n = n
        self.denom = 2.0 * sum(i * i for i in range(1, n + 1))
        self.weights = np.arange(-n, n + 1, dtype=np.float64)
        self._hist: Optional[np.ndarray] = None  # rows [start, total)
        self._start = 0
        self._emitted = 0
        self._total = 0

    def push(self, rows: np.ndarray, final: bool) -> np.ndarray:
        if len(rows):
            rows = np.asarray(rows, np.float64)
            self._hist = (
                rows if self._hist is None or not len(self._hist)
                else np.vstack([self._hist, rows])
            )
            self._total += len(rows)
        n, total = self.n, self._total
        last_ready = total - 1 - (0 if final else n)
        count = last_ready - self._emitted + 1
        if count <= 0 or self._hist is None:
            return np.zeros((0, self._hist.shape[1] if self._hist is not
                             None else 0), np.float64)
        t = np.arange(self._emitted, last_ready + 1)[:, None]
        idx = np.clip(t + np.arange(-n, n + 1)[None, :], 0, total - 1)
        window = self._hist[idx - self._start]      # [count, 2n+1, F]
        out = np.einsum("k,tkf->tf", self.weights, window) / self.denom
        self._emitted = last_ready + 1
        keep_from = max(self._emitted - n, 0)
        self._hist = self._hist[keep_from - self._start:]
        self._start = keep_from
        return out


class StreamingFeaturizer:
    """Chunked drop-in for the FBank/LogFbank/MFCC oracles.

    push(samples) -> newly-complete [t, F] feature rows (possibly empty);
    finish() -> the final rows (tail-padded frame + delta flush).
    Per-utterance CMVN (mean_norm/var_norm) is rejected: it needs global
    statistics and has no streaming form.
    """

    def __init__(self, feature: audio.Feature):
        if feature.mean_norm or feature.var_norm:
            raise ValueError(
                "per-utterance CMVN cannot stream (global statistics); "
                "build the feature without mean_norm/var_norm"
            )
        if not isinstance(feature, (audio.MFCC, audio.LogFbank,
                                    audio.FBank)):
            raise ValueError(
                f"unsupported feature type {type(feature).__name__}"
            )
        if getattr(feature, "center", False):
            raise ValueError(
                "streaming does not support center=True (librosa) framing:"
                " centered frames need future samples and an end-of-stream"
                " reflection; use convention='reference'"
            )
        self.feature = feature
        self.frame_len = int(round(feature.win_len * feature.fs))
        self.frame_step = int(round(feature.win_step * feature.fs))
        self._window = audio.get_window(feature.window)(self.frame_len)
        f = feature
        self._fb = audio.mel_filterbank(
            f.nfilt, f.nfft, f.fs, f.low_freq, f.high_freq, f.htk,
            construction=f.filterbank, norm=f.fb_norm,
        )
        if isinstance(f, audio.MFCC):
            self._dct = audio.dct2_ortho_matrix(f.nfilt, f.num_cep)
        # The oracles CHAIN delta passes off the previous column
        # (``out.append(delta(out[-1], 2))``), so d/dd reduce to a count
        # of chained passes: d-only and dd-only are one pass, d+dd two.
        n_passes = int(getattr(f, "d", False)) + int(getattr(f, "dd", False))
        self._deltas = [_DeltaStream(2) for _ in range(n_passes)]
        self._pre = np.zeros((0,), np.float64)  # preemphasized, unframed
        self._prev_raw: Optional[float] = None
        self._frames_done = 0
        self._samples_seen = 0
        # per-column queues of ready rows: base, then one per delta pass
        self._q: List[List[np.ndarray]] = [
            [] for _ in range(1 + n_passes)
        ]
        self._finished = False

    @property
    def num_feats(self) -> int:
        return self.feature.num_feats

    # -- per-frame (streaming-safe) part of the oracle chain ---------------
    def _base_rows(self, frames: np.ndarray) -> np.ndarray:
        f = self.feature
        pspec = audio.power_spectrum(frames * self._window[None, :], f.nfft)
        energy = np.sum(pspec, axis=1)
        energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)
        feat = pspec @ self._fb.T
        feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
        feat = f._floor(feat)
        energy = f._floor(energy)
        if isinstance(f, audio.MFCC):
            cep = audio.lifter(np.log(feat) @ self._dct.T, f.cep_lifter)
            if f.append_energy:
                cep[:, 0] = np.log(energy)
            return cep
        if isinstance(f, audio.LogFbank):
            out = np.log(feat)
            if f.append_energy:
                out = np.hstack([out, np.log(energy)[:, None]])
            return out
        return feat  # FBank (linear)

    def push(self, samples: np.ndarray) -> np.ndarray:
        assert not self._finished, "push() after finish()"
        samples = np.asarray(samples).reshape(-1)
        self._samples_seen += len(samples)
        if len(samples):
            # causal preemphasis with a one-sample carry, in the INPUT
            # dtype (the oracle computes x[1:] - c*x[:-1] without
            # promoting, so f32 wavs must round identically here)
            if self._prev_raw is None:
                pre = np.append(
                    samples[0], samples[1:] - self.feature.preemph
                    * samples[:-1]
                )
            else:
                shifted = np.concatenate(
                    [np.asarray([self._prev_raw], samples.dtype),
                     samples[:-1]]
                )
                pre = samples - np.asarray(
                    self.feature.preemph, samples.dtype
                ) * shifted
            self._pre = np.concatenate([self._pre.astype(pre.dtype), pre])
            self._prev_raw = samples[-1]
        n_ready = (
            0 if len(self._pre) < self.frame_len
            else 1 + (len(self._pre) - self.frame_len) // self.frame_step
        )
        return self._advance(n_ready, final=False)

    def finish(self) -> np.ndarray:
        assert not self._finished
        self._finished = True
        if self._samples_seen == 0:
            return np.zeros((0, self.num_feats), np.float32)
        nf = audio.num_frames(
            self._samples_seen, self.frame_len, self.frame_step
        )
        rest = nf - self._frames_done
        if rest > 0:
            # zero-pad in the PREEMPHASIZED domain: the oracle
            # preemphasizes first, then pads frames with zeros
            need = (rest - 1) * self.frame_step + self.frame_len
            if need > len(self._pre):
                self._pre = np.concatenate(
                    [self._pre, np.zeros(need - len(self._pre))]
                )
        return self._advance(rest, final=True)

    def _advance(self, n_new: int, final: bool) -> np.ndarray:
        if n_new > 0:
            idx = (
                np.arange(self.frame_len)[None, :]
                + self.frame_step * np.arange(n_new)[:, None]
            )
            base = self._base_rows(self._pre[idx])
            self._pre = self._pre[n_new * self.frame_step:]
            self._frames_done += n_new
        else:
            base = np.zeros((0, 0), np.float64)
        cols = 1 + len(self._deltas)
        if len(base):
            self._q[0].append(base)
        rows = base
        for i, stream in enumerate(self._deltas):
            rows = stream.push(rows, final)
            if len(rows):
                self._q[i + 1].append(rows)
        ready = [
            np.vstack(q) if q else np.zeros((0, 1), np.float64)
            for q in self._q[:cols]
        ]
        k = min(len(r) for r in ready)
        if k == 0:
            return np.zeros((0, self.num_feats), np.float32)
        out = np.hstack([r[:k] for r in ready])
        for i in range(cols):
            rest = ready[i][k:]
            self._q[i] = [rest] if len(rest) else []
        return np.ascontiguousarray(out, np.float32)


class GreedyStream:
    """CTC greedy decoding with carried collapse state: argmax per frame,
    emit on change, drop blanks — across chunk boundaries."""

    def __init__(self, blank_id: int):
        self.blank_id = blank_id
        self._prev = blank_id
        self.ids: List[int] = []

    def push(self, logits, n_valid: Optional[int] = None) -> None:
        """logits [t, V+1] for the new frames (batch row already selected),
        the first ``n_valid`` real (all where None): a NumPy array, or a
        tensor whose argmax is taken on its device."""
        logits = logits if n_valid is None else logits[:n_valid]
        if torch.is_tensor(logits):
            self.push_ids(logits.argmax(-1).cpu().tolist())
        else:
            self.push_ids(np.argmax(logits, axis=-1).tolist())

    def push_ids(self, tokens) -> None:
        """The frames' argmax ids, in order."""
        for tok in tokens:
            tok = int(tok)
            if tok != self._prev and tok != self.blank_id:
                self.ids.append(tok)
            self._prev = tok


class BeamStream:
    """Streaming CTC prefix beam search: the dense beam state
    (``ops/beam.py`` ``BeamState``) carries across chunks on the logits'
    device; decoded prefixes are spliced on the host from each chunk's
    walk back (its prefixes, emit counts and start slots)."""

    def __init__(self, blank_id: int, beam_width: int = 16,
                 prune: int = 0, lm=None, lm_alpha: float = 1.0,
                 lm_beta: float = 0.0, device: torch.device | str = "cpu"):
        self.blank_id = blank_id
        self.beam_width = beam_width
        self.prune = prune
        self.lm, self.lm_alpha, self.lm_beta = lm, lm_alpha, lm_beta
        self._state = beam_ops.beam_stream_init(
            beam_width, 0 if lm is None else lm.init_state(), device)
        self._prefixes: List[List[int]] = [[] for _ in range(beam_width)]

    def push(self, logits: torch.Tensor, n_valid: Optional[int] = None
             ) -> None:
        """logits [t, V+1] for the new frames (blank = last id), on the
        device the beam state lives on; the first ``n_valid`` are real."""
        t = len(logits)
        if t == 0:
            return
        lp = torch.log_softmax(logits.float(), dim=-1)
        self._state, pref, emits, slots, _ = beam_ops.beam_stream_chunk(
            lp, t if n_valid is None else n_valid, self._state,
            self.beam_width, self.blank_id, self.prune, lm=self.lm,
            lm_alpha=self.lm_alpha, lm_beta=self.lm_beta)
        # one copy to the host: the prefixes, then the counts and slots
        got = torch.cat([pref, emits[:, None], slots[:, None]], 1).cpu()
        pref, emits, slots = got[:, :t], got[:, t], got[:, t + 1]
        self._prefixes = [
            self._prefixes[int(slots[w])] + pref[w, : int(emits[w])].tolist()
            for w in range(self.beam_width)
        ]

    @property
    def ids(self) -> List[int]:
        scores = np.logaddexp(self._state.p_b.cpu().numpy(),
                              self._state.p_nb.cpu().numpy())
        return self._prefixes[int(np.argmax(scores))]


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class MultiStreamRecognizer:
    """N concurrent audio streams decoded by ONE model step per tick — the
    production-serving shape: the batch dimension carries independent
    callers, per-stream recurrent state rides the same carries, and a
    stream with no ready frames this tick passes a zero length (the masked
    recurrence holds its state exactly).

    push(stream, samples) buffers audio per stream; tick() runs one
    [N, chunk_frames, F] model step over whatever is ready; finish(stream)
    flushes that stream and returns its ids.  Greedy decoding per stream.
    """

    def __init__(self, model, feature: audio.Feature, n_streams: int,
                 chunk_frames: int = 128):
        if any(e.rnn.bidirectional for e in model.rnn.layers):
            raise ValueError(
                "streaming needs a unidirectional model; train with "
                '--params "bidirectional=false"'
            )
        self.model = model
        self.device = _model_device(model)
        self.n = n_streams
        self.chunk_frames = chunk_frames
        self.feature = feature
        self.feats = [StreamingFeaturizer(feature) for _ in range(n_streams)]
        self.carries = model.init_stream_carries(n_streams)
        self.decoders = [GreedyStream(model.blank_id)
                         for _ in range(n_streams)]
        self._pending = [
            np.zeros((0, feature.num_feats), np.float32)
            for _ in range(n_streams)
        ]
        self._done = [False] * n_streams

    def push(self, stream: int, samples: np.ndarray) -> None:
        assert not self._done[stream], "push() after finish()"
        rows = self.feats[stream].push(samples)
        if len(rows):
            self._pending[stream] = (
                np.vstack([self._pending[stream], rows])
                if len(self._pending[stream]) else rows
            )

    def tick(self) -> None:
        """One model step over every stream's ready frames (up to
        chunk_frames each; streams with nothing ready hold state)."""
        cf = self.chunk_frames
        f_dim = self.feature.num_feats
        batch = np.zeros((self.n, cf, f_dim), np.float32)
        n_valid = np.zeros((self.n,), np.int32)
        for s in range(self.n):
            k = min(cf, len(self._pending[s]))
            if k:
                batch[s, :k] = self._pending[s][:k]
                self._pending[s] = self._pending[s][k:]
                n_valid[s] = k
        if not n_valid.any():
            return
        logits, self.carries = self.model.apply_streaming(
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(n_valid).to(self.device), self.carries)
        tokens = logits.argmax(-1).cpu().numpy()
        for s in range(self.n):
            if n_valid[s]:
                self.decoders[s].push_ids(tokens[s, : n_valid[s]])

    def finish(self, stream: int) -> List[int]:
        """Flush one stream (others keep running) and return its ids."""
        assert not self._done[stream]
        rows = self.feats[stream].finish()
        if len(rows):
            self._pending[stream] = (
                np.vstack([self._pending[stream], rows])
                if len(self._pending[stream]) else rows
            )
        while len(self._pending[stream]):
            self.tick()
        self._done[stream] = True
        return self.decoders[stream].ids


class StreamingRecognizer:
    """wav chunks in, transcript ids out — bounded memory at any length.

    Glues StreamingFeaturizer -> AcousticModel.apply_streaming (carried
    recurrent state) -> GreedyStream, or BeamStream with ``beam_width``.
    ``chunk_frames`` fixes the model step's shape; ragged feature chunks
    are padded and masked.  The model's device is the stream's.
    """

    def __init__(self, model, feature: audio.Feature,
                 chunk_frames: int = 512, beam_width: int = 0,
                 prune: int = 0, lm=None, lm_alpha: float = 1.0,
                 lm_beta: float = 0.0):
        if any(e.rnn.bidirectional for e in model.rnn.layers):
            raise ValueError(
                "streaming needs a unidirectional model (the backward "
                "direction reads the future); train with "
                '--params "bidirectional=false"'
            )
        self.model = model
        self.device = _model_device(model)
        self.feat = StreamingFeaturizer(feature)
        self.chunk_frames = chunk_frames
        self.carries = model.init_stream_carries(1)
        self.decoder = (
            BeamStream(model.blank_id, beam_width, prune, lm=lm,
                       lm_alpha=lm_alpha, lm_beta=lm_beta,
                       device=self.device)
            if beam_width > 0 else GreedyStream(model.blank_id)
        )
        self._pending = np.zeros((0, feature.num_feats), np.float32)

    def push(self, samples: np.ndarray) -> None:
        self._consume(self.feat.push(samples), final=False)

    def finish(self) -> List[int]:
        self._consume(self.feat.finish(), final=True)
        return self.decoder.ids

    def _consume(self, rows: np.ndarray, final: bool) -> None:
        if len(rows):
            self._pending = (
                np.vstack([self._pending, rows]) if len(self._pending)
                else rows
            )
        cf = self.chunk_frames
        while len(self._pending) >= cf or (final and len(self._pending)):
            n = min(cf, len(self._pending))
            chunk = self._pending[:n]
            self._pending = self._pending[n:]
            if n < cf:
                chunk = np.pad(chunk, ((0, cf - n), (0, 0)))
            logits, self.carries = self.model.apply_streaming(
                torch.from_numpy(np.ascontiguousarray(chunk[None])).to(
                    self.device),
                torch.full((1,), n, dtype=torch.int32, device=self.device),
                self.carries)
            self.decoder.push(logits[0], n)
