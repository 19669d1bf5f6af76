"""The CUDA kernels of asr_study_torch against their plain versions, on
the card.  Every test here needs an NVIDIA GPU and skips without one; the
machine with the card has no JAX, so this file imports none and is run
there without the repo's conftest::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import json

import numpy as np
import pytest
import torch

import dp_ranks
from asr_study_torch import _build
from asr_study_torch.cli.predict import pack_batches, serve_batch
from asr_study_torch.data import wire
from asr_study_torch.features.device import DeviceFeaturizer, spectral_plain
from asr_study_torch.features.fbank import (KernelFeaturizer, chain_design,
                                            fbank, launch_dft)
from asr_study_torch.features.select import featurizer
from asr_study_torch.models.zoo import (build_model, deep_blstm, deep_gru,
                                        graves2006)
from asr_study_torch.ops import beam, ctc
from asr_study_torch.ops.dpack import dpack_decode, dpack_decode_plain
from asr_study_torch.ops.bilstm import (BiLSTMFunction, LSTMFunction, bilstm,
                                        bilstm_bwd, bilstm_bwd_gates_plain,
                                        bilstm_bwd_plain, bilstm_plain,
                                        cluster_info, lstm, lstm_bwd,
                                        lstm_bwd_gates_plain, lstm_bwd_plain,
                                        lstm_geometry, lstm_plain)
from asr_study_torch.ops.gru import _dwh as gru_dwh
from asr_study_torch.ops.gru import (BiGRUFunction, GRUFunction, bigru,
                                     bigru_bwd, bigru_bwd_plain,
                                     bigru_bwd_res_plain, bigru_plain, gru,
                                     gru_bwd, gru_bwd_plain,
                                     gru_bwd_res_plain, gru_cluster_info,
                                     gru_geometry, gru_plain)
from asr_study_torch.ops.ln_lstm import (BiLNLSTMFunction, LNLSTMFunction,
                                         bi_ln_lstm, bi_ln_lstm_bwd,
                                         bi_ln_lstm_bwd_plain,
                                         bi_ln_lstm_plain, launch_bwd,
                                         launch_fwd, ln_cluster_info,
                                         ln_geometry, ln_lstm, ln_lstm_bwd,
                                         ln_lstm_bwd_plain, ln_lstm_plain)
from asr_study_torch.ops.recurrence import Geometry
from asr_study_torch.parallel import dp
from asr_study_torch.text.lm import fit_ngram_lm
from asr_study_torch.models.cells import ZoneoutLSTMCell
from asr_study_torch.ops.mi_lstm import (BiMILSTMFunction, MILSTMFunction,
                                         bi_mi_lstm, bi_mi_lstm_bwd,
                                         bi_mi_lstm_bwd_plain,
                                         bi_mi_lstm_plain, mi_cluster_info,
                                         mi_geometry, mi_lstm, mi_lstm_bwd,
                                         mi_lstm_bwd_plain, mi_lstm_plain)
from asr_study_torch.ops.mi_lstm import launch_bwd as mi_launch_bwd
from asr_study_torch.ops.mi_lstm import launch_fwd as mi_launch_fwd
from asr_study_torch.ops.zoneout_lstm import (BiZoneoutLSTMFunction,
                                              ZoneoutLSTMFunction,
                                              bi_zoneout_lstm,
                                              bi_zoneout_lstm_bwd,
                                              bi_zoneout_lstm_bwd_plain,
                                              bi_zoneout_lstm_plain,
                                              zoneout_cluster_info,
                                              zoneout_geometry,
                                              zoneout_lstm, zoneout_lstm_bwd,
                                              zoneout_lstm_bwd_plain,
                                              zoneout_lstm_plain)
from asr_study_torch.ops.zoneout_lstm import launch_bwd as zo_launch_bwd
from asr_study_torch.ops.zoneout_lstm import launch_fwd as zo_launch_fwd
from asr_study_torch.train.trainer import Trainer, make_optimizer

pytestmark = pytest.mark.gpu

# chip_smoke.py's bounds: |kernel - plain| <= atol + rtol * |plain|
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRU_TOL = dict(rtol=1e-5, atol=1e-4)
CTC_TOL = dict(rtol=1e-5, atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _wavs(seed, lengths, n_pad):
    rng = np.random.RandomState(seed)
    w = np.zeros((len(lengths), n_pad), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        w[i, :n] = 0.4 * np.sin(2 * np.pi * 180 * (i + 1) * t) \
            + 0.05 * rng.randn(n)
    return torch.from_numpy(w), torch.tensor(lengths, dtype=torch.int32)


def _check_fbank(cuda, design, kind, kw, lengths, n_pad):
    """One design against the plain version, two launches bit-equal: the
    design the size rule picks through the wrapper (by_design counted), or
    else the DFT design through its launch helper on the padded signal (the
    wrapper's route for the shapes the FFT design does not take)."""
    w, lens = _wavs(0, lengths, n_pad)
    feat = KernelFeaturizer(kind=kind, device=cuda, **kw)
    pre, t_out, _ = feat._prep(w.to(cuda), lens.to(cuda))
    before, by_design = fbank.launches, dict(fbank.by_design)
    if chain_design(feat.chain) == design:
        got = fbank(feat.chain, pre, t_out)
        again = fbank(feat.chain, pre, t_out)
        by_design[design] += 2
        before += 2
    else:
        need = (t_out - 1) * feat.chain.frame_step + feat.chain.frame_len
        padded = torch.nn.functional.pad(pre, (0, max(0, need
                                                      - pre.shape[1])))
        got, again = (torch.empty(len(lengths), t_out, feat.chain.num_out,
                                  device=cuda) for _ in range(2))
        launch_dft(feat.chain, padded, t_out, got)
        launch_dft(feat.chain, padded, t_out, again)
    assert fbank.launches == before and fbank.by_design == by_design
    want = spectral_plain(feat.chain, pre, t_out)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.shape == want.shape == (len(lengths), t_out,
                                       feat.chain.num_out)
    if kind == "fbank":      # linear energies: relative error
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    else:                    # log domain (chip_smoke.py FBANK_TOL)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("design", ["fft", "dft"])
@pytest.mark.parametrize("kind,kw", [
    ("mfcc", {}),
    ("mfcc", {"convention": "librosa"}),
    ("mfcc", {"append_energy": False}),
    ("logfbank", {"append_energy": True}),
    ("fbank", {}),
])
def test_fbank_kernel_matches_plain(cuda, kind, kw, design):
    _check_fbank(cuda, design, kind, kw, [9000, 5000, 700, 12000, 3],
                 12000)


@pytest.mark.parametrize("design", ["fft", "dft"])
@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_fbank_kernel_fft_sizes(cuda, nfft, design):
    """frame_len equal to nfft: every sample of the transform is live."""
    _check_fbank(cuda, design, "mfcc", {"nfft": nfft,
                                        "win_len": nfft / 16000},
                 [9000, 5000, 700, 12000, 3], 12000)


@pytest.mark.parametrize("design", ["fft", "dft"])
def test_fbank_kernel_near_the_shared_memory_limit(cuda, design):
    """2048-sample frames a hop of 480 apart: the FFT design's CTA takes
    203,168 B of the 227 KB it may hold."""
    _check_fbank(cuda, design, "mfcc", {"nfft": 2048, "win_len": 0.128,
                                        "win_step": 0.03},
                 [9000, 5000, 700, 12000, 3], 12000)


@pytest.mark.parametrize("design", ["fft", "dft"])
@pytest.mark.parametrize("lengths,n_pad", [([400], 400), ([12000], 12000),
                                           ([3], 2048)],
                         ids=["T=1", "B=1", "3 samples"])
def test_fbank_kernel_edge_shapes(cuda, lengths, n_pad, design):
    _check_fbank(cuda, design, "mfcc", {}, lengths, n_pad)


@pytest.mark.parametrize("kw", [
    {"nfft": 400}, {"nfft": 256},
    {"nfft": 2048, "win_len": 0.128, "win_step": 0.064}],
    ids=["nfft 400", "frame past nfft", "tile past shared memory"])
def test_fbank_kernel_dft_route(cuda, kw):
    """The shapes the size rule sends to the DFT design, through the
    wrapper: nfft not a power of two; a 400-sample frame over nfft=256;
    2048-sample frames a hop of 1024 apart, whose FFT-design tile would
    not fit in a CTA's shared memory."""
    feat = KernelFeaturizer(kind="mfcc", device=cuda, **kw)
    assert chain_design(feat.chain) == "dft"
    _check_fbank(cuda, "dft", "mfcc", kw, [9000, 5000, 700, 12000, 3],
                 12000)


# shapes ragged for the cluster design's tiling (ops/bilstm.py
# lstm_geometry): T=1; H=100 over 8 CTAs of 13 units; B=5 and B=33, rows
# left over in the last group of R; "dead": the last row masked on every
# frame
LSTM_RAGGED = [(1, 33, 256, False), (37, 5, 100, True), (23, 5, 256, True),
               (40, 33, 256, True), (29, 33, 100, True)]


def _lstm_cases(sizes):
    """Parametrise (t, b, h, dead) over ``sizes`` (no dead row) and
    LSTM_RAGGED; the ids of ``sizes`` stay "t-b-h"."""
    cases = [(*size, False) for size in sizes] + LSTM_RAGGED
    return pytest.mark.parametrize(
        "t,b,h,dead", cases,
        ids=[f"{t}-{b}-{h}" + ("-dead" if d else "") for t, b, h, d in cases])


def _count_design(wrapper, h, b, ndir):
    """-> (launches, launches of the design lstm_geometry gives)."""
    design = lstm_geometry(h, b, ndir).design
    return wrapper.launches, wrapper.by_design[design]


@_lstm_cases([(12, 4, 8), (37, 5, 100), (50, 9, 256), (3, 1, 300),
              (20, 3, 512)])
def test_bilstm_kernel_matches_plain(cuda, t, b, h, dead):
    g = torch.Generator().manual_seed(h)
    xp_f = torch.randn(t, b, 4 * h, generator=g)
    xp_b = torch.randn(t, b, 4 * h, generator=g)
    wh_f = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    wh_b = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    if dead:
        lengths[-1] = 0
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    args = [a.to(cuda) for a in (xp_f, xp_b, mask, wh_f, wh_b)]
    before = _count_design(bilstm, h, b, 2)
    got = bilstm(*args)
    assert _count_design(bilstm, h, b, 2) == (before[0] + 1, before[1] + 1)
    want = bilstm_plain(*args)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("h_f", "c_f", "h_b", "c_b"), got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=1e-4, msg=name)


def test_bilstm_kernel_refuses_noncontiguous(cuda):
    xp = torch.zeros(4, 2, 32, device=cuda)
    wh = torch.zeros(8, 32, device=cuda)
    wh_t = torch.zeros(32, 8, device=cuda).t()      # [8, 32], strided
    mask = torch.ones(4, 2, 1, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bilstm(xp, xp, mask, wh_t, wh)


def test_select_picks_kernel_on_cuda(cuda):
    assert type(featurizer("mfcc", cuda)) is KernelFeaturizer
    assert type(featurizer("mfcc", "cpu")) is DeviceFeaturizer


@pytest.mark.parametrize("make", [deep_blstm, graves2006])
def test_slice_on_card_matches_cpu(cuda, make):
    """The serving slice, kernels on the card against plain on the CPU."""
    rng = np.random.RandomState(1)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32)
            for n in (9000, 4000, 6500)]
    chunk, cap, n_pad, _ = pack_batches(wavs, 3)
    m_cpu = make("num_hiddens=24,num_layers=2", num_classes=27,
                 generator=torch.Generator().manual_seed(0)).eval()
    m_gpu = make("num_hiddens=24,num_layers=2", num_classes=27,
                 generator=torch.Generator().manual_seed(0),
                 device=cuda).eval()
    f0, b0 = fbank.launches, bilstm.launches
    got = serve_batch(m_gpu, featurizer("mfcc", cuda),
                      torch.from_numpy(chunk).to(cuda), 3, n_pad)
    assert fbank.launches == f0 + 1
    assert bilstm.launches == b0 + len(m_gpu.rnn.layers)
    want = serve_batch(m_cpu, featurizer("mfcc", "cpu"),
                       torch.from_numpy(chunk), 3, n_pad)
    torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=0,
                               atol=2e-3)
    assert torch.equal(got.feat_lengths.cpu(), want.feat_lengths)


def _dpack_case(name):
    """tests/test_wire.py's dpack edge cases: width extremes in one batch
    (w=0, w=1-2, w=16), and block counts of 1, 3, 9 and 13."""
    rng = np.random.RandomState(9)
    if name == "width extremes":
        return [(rng.randn(n) * 0.3).astype(np.float32)
                for n in (3100, 7000, 4095)] + [
            np.zeros(4096, np.int16), np.ones(4097, np.int16),
            np.tile(np.array([32767, -32768], np.int16), 2100)]
    return [(rng.randn(int(name)) * 0.2).astype(np.float32)]


@pytest.mark.parametrize("name", ["width extremes", "100", "12281", "36859",
                                  "53247", "48 rows of 8 s"])
def test_dpack_kernel_matches_plain(cuda, name):
    """The one-launch design: the whole [scap] stream bit for bit against
    the plain version and the two-launch design (csrc/dpack.cu through its
    C entry point), and the unpacked batch equal to the pcm16 wire's.  48
    rows of 8 s are ~1,500 dpack blocks, more than the cooperative grid
    has CTAs."""
    if name == "48 rows of 8 s":
        rng = np.random.RandomState(48)
        wavs = [(rng.randn(128000) * 0.2).astype(np.float32)
                for _ in range(48)]
    else:
        wavs = _dpack_case(name)
    b = len(wavs)
    cap, scap = wire.dpack_measure([wavs], b, align=256)
    flat = torch.from_numpy(wire.pack_audio(wavs, cap, batch=b,
                                            codec="dpack",
                                            scap=scap)).to(cuda)
    args = (*wire.dpack_regions(flat, b, scap), scap)
    before = dpack_decode.launches
    got = dpack_decode(*args)
    assert dpack_decode.launches == before + 1
    want = dpack_decode_plain(*args)
    payload, row_start, widths = args[:3]
    two = torch.empty(scap, dtype=torch.float32, device=cuda)
    totals = torch.empty(scap // 4096, dtype=torch.int32, device=cuda)
    assert _build.lib().asr_dpack_decode(
        payload.data_ptr(), payload.shape[0], row_start.data_ptr(),
        widths.data_ptr(), totals.data_ptr(), two.data_ptr(), scap // 4096,
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, two)
    n_pad = -(-max(len(w) for w in wavs) // 2048) * 2048
    pcm = wire.pack_audio(wavs, wire.wire_cap(b, sum(map(len, wavs))))
    w_d, l_d = wire.unpack_audio(flat, b, n_pad, codec="dpack", scap=scap)
    w_p, l_p = wire.unpack_audio(torch.from_numpy(pcm).to(cuda), b, n_pad)
    assert torch.equal(w_d, w_p) and torch.equal(l_d, l_p)


def test_dpack_kernel_on_two_streams(cuda):
    """Decodes on two streams at once, each with its own scratch of CTA
    totals: both bit for bit against the plain version."""
    rng = np.random.RandomState(7)
    wavs = [(rng.randn(n) * 0.2).astype(np.float32)
            for n in (128000, 96000, 64000, 48000)]
    cap, scap = wire.dpack_measure([wavs], len(wavs), align=256)
    flat = torch.from_numpy(wire.pack_audio(wavs, cap, batch=len(wavs),
                                            codec="dpack",
                                            scap=scap)).to(cuda)
    args = (*wire.dpack_regions(flat, len(wavs), scap), scap)
    want = dpack_decode_plain(*args)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                got.append(dpack_decode(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(g, want) for g in got)


def test_dpack_serving_slice_launches(cuda):
    """The dpack serving slice on the card: one dpack_decode launch a
    batch, and the pcm16 slice's logits and transcripts exactly."""
    rng = np.random.RandomState(2)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32)
            for n in (9000, 4000, 6500, 12000, 300, 7000)]
    model = deep_blstm("num_hiddens=24,num_layers=2", num_classes=27,
                       generator=torch.Generator().manual_seed(0),
                       device=cuda).eval()
    feat = featurizer("mfcc", cuda)
    pcm, pcm_cap, n_pad, _ = pack_batches(wavs, 3)
    chunk, cap, n_pad_d, scap = pack_batches(wavs, 3, "dpack")
    assert n_pad_d == n_pad
    dev_chunk = torch.from_numpy(chunk).to(cuda)
    dev_pcm = torch.from_numpy(pcm).to(cuda)
    d0, f0 = dpack_decode.launches, fbank.launches
    for k in range(2):
        got = serve_batch(model, feat, dev_chunk[k * cap: (k + 1) * cap], 3,
                          n_pad, "dpack", scap)
        want = serve_batch(model, feat,
                           dev_pcm[k * pcm_cap: (k + 1) * pcm_cap], 3, n_pad)
        assert torch.equal(got.logits, want.logits)
        assert torch.equal(got.decoded, want.decoded)
    assert dpack_decode.launches == d0 + 2
    assert fbank.launches == f0 + 4


def _bilstm_case(cuda, t, b, h, seed, dead=False):
    g = torch.Generator().manual_seed(seed)
    xp_f = torch.randn(t, b, 4 * h, generator=g)
    xp_b = torch.randn(t, b, 4 * h, generator=g)
    wh_f = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    wh_b = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    if dead:
        lengths[-1] = 0
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = (torch.randn(t, b, h, generator=g), torch.randn(t, b, h, generator=g))
    return ([a.to(cuda) for a in (xp_f, xp_b, mask, wh_f, wh_b)],
            [a.to(cuda) for a in dh])


@_lstm_cases([(12, 4, 8), (37, 5, 100), (50, 9, 256), (3, 1, 300),
              (512, 32, 256), (20, 3, 512)])
def test_bilstm_bwd_kernel_matches_plain(cuda, t, b, h, dead):
    """bilstm_bwd against the plain walk that recomputes the gates; where
    the wide design runs (H=300, H=512) the kernel reads the gates that
    the forward kept in its res, and is held against the plain walk from
    those gates too."""
    args, dh = _bilstm_case(cuda, t, b, h, seed=h + t, dead=dead)
    *res, saved = bilstm(*args, residual=True)
    assert len(saved) == (2 if lstm_geometry(h, b, 2).design == "wide"
                          else 0)
    before = _count_design(bilstm_bwd, h, b, 2)
    got = bilstm_bwd(*args, *res, *dh, saved)
    assert _count_design(bilstm_bwd, h, b, 2) == (before[0] + 1,
                                                  before[1] + 1)
    want = bilstm_bwd_plain(*args, *res, *dh)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("dxp_f", "dxp_b"), got, want):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)
    if saved:
        want = bilstm_bwd_gates_plain(*saved, args[2], args[3], args[4],
                                      res[1], res[3], *dh)
        for name, g_, w_ in zip(("dxp_f", "dxp_b"), got, want):
            torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256), (20, 5, 512)])
def test_bilstm_function_matches_autograd_on_card(cuda, t, b, h):
    """Gradients of xp and wh through BiLSTMFunction (both kernels)
    against autograd through the plain loop, on the card."""
    args, dh = _bilstm_case(cuda, t, b, h, seed=7)
    grads = []
    for fn in (BiLSTMFunction.apply,
               lambda *a: bilstm_plain(*a)[0::2]):
        leaves = [a.clone().requires_grad_() for a in
                  (args[0], args[1], args[3], args[4])]
        h_f, h_b = fn(leaves[0], leaves[1], args[2], leaves[2], leaves[3])
        torch.autograd.backward((h_f, h_b), dh)
        grads.append([leaf.grad for leaf in leaves])
    for name, g_, w_ in zip(("dxp_f", "dxp_b", "dwh_f", "dwh_b"), *grads):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


def _lattice(cuda, b, t, l_max, seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(b, t, 28, generator=g)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    labels = torch.randint(0, 27, (b, l_max), generator=g)
    lab_lens = torch.randint(0, l_max + 1, (b,), generator=g)
    lab_lens[-1] = 0
    lab_lens[0] = l_max
    with torch.no_grad():
        return [x.to(cuda) for x in ctc.lattice(logits, lengths, labels,
                                                lab_lens)]


def _ctc_entry(name, *args):
    """One CTC kernel through its C entry point: ``args`` the tensors (the
    last one the output), then T, B, S -> the entry point's error code."""
    tensors, dims = args[:-3], args[-3:]
    return getattr(_build.lib(), name)(
        *(a.data_ptr() for a in tensors), *dims,
        torch.cuda.current_stream().cuda_stream)


def _ctc_held(got, want):
    """alpha or gamma: floor entries equal, the rest within CTC_TOL."""
    floor = want <= -5e29
    assert torch.equal(got <= -5e29, floor)
    torch.testing.assert_close(got[~floor], want[~floor], **CTC_TOL)


# (B, T, L): S = 2L+1 over the warp design's lane boundaries (S = 1, 31,
# 33, 63, 65, 97, 543) and one above its cap (545, the block design); B =
# 1, 5, 33; T = 1, 2, 512; every batch has a row of label length 0, and
# (3, 40, 30), (5, 2, 15) and (1, 1, 0)'s neighbours infeasible rows
@pytest.mark.parametrize("b,t,l_max", [
    (4, 14, 4), (3, 40, 30), (32, 512, 48), (1, 1, 0), (5, 2, 15),
    (33, 80, 16), (5, 140, 31), (33, 140, 32), (1, 512, 48),
    (2, 560, 271), (5, 600, 272)])
def test_ctc_kernels_match_plain(cuda, b, t, l_max):
    """alpha and gamma of the design ``ctc_design`` picks, through the
    wrappers, and of both designs through their C entry points: floor
    entries equal, the rest within CTC_TOL, the posterior gradient within
    1e-5; two launches on the same inputs bit-equal; the launch counts by
    design.  The warp design's entry points refuse S above its cap."""
    lp_ext, valid, skip, end, ll = _lattice(cuda, b, t, l_max, seed=t)
    s = lp_ext.shape[2]
    skip2 = ctc.skip_from_source(skip)
    end_ind = ctc.end_indicator(end, ll, s)
    design = ctc.ctc_design(s)
    a0, b0 = ctc.ctc_alpha.launches, ctc.ctc_beta.launches
    da0, db0 = dict(ctc.ctc_alpha.by_design), dict(ctc.ctc_beta.by_design)
    alpha = ctc.ctc_alpha(lp_ext, valid, skip)
    gamma = ctc.ctc_beta(lp_ext, valid, alpha, skip2, end_ind)
    assert (ctc.ctc_alpha.launches, ctc.ctc_beta.launches) == (a0 + 1,
                                                               b0 + 1)
    assert ctc.ctc_alpha.by_design == {**da0, design: da0[design] + 1}
    assert ctc.ctc_beta.by_design == {**db0, design: db0[design] + 1}
    assert torch.equal(ctc.ctc_alpha(lp_ext, valid, skip), alpha)
    assert torch.equal(ctc.ctc_beta(lp_ext, valid, alpha, skip2, end_ind),
                       gamma)
    alpha_p = ctc.ctc_alpha_plain(lp_ext, valid, skip)
    gamma_p = ctc.ctc_beta_plain(lp_ext, valid, alpha_p, skip2, end_ind)
    _ctc_held(alpha, alpha_p)
    _ctc_held(gamma, gamma_p)
    ones = torch.ones(b, device=cuda)
    dlp = ctc.posterior_grad(gamma, ctc.final_logp(alpha[-1], end, ll), ones)
    dlp_p = ctc.posterior_grad(gamma_p, ctc.final_logp(alpha_p[-1], end, ll),
                               ones)
    torch.testing.assert_close(dlp, dlp_p, rtol=0, atol=1e-5)
    for suffix in ("_warp", ""):
        a_k, g_k = torch.empty_like(alpha), torch.empty_like(gamma)
        err_a = _ctc_entry("asr_ctc_alpha" + suffix, lp_ext, valid, skip,
                           a_k, t, b, s)
        err_b = _ctc_entry("asr_ctc_beta" + suffix, lp_ext, valid, alpha_p,
                           skip2, end_ind, g_k, t, b, s)
        if suffix and s > ctc.CTC_WARP_MAX_S:
            assert err_a != 0 and err_b != 0
            continue
        assert err_a == 0 and err_b == 0
        torch.cuda.synchronize()
        _ctc_held(a_k, alpha_p)
        _ctc_held(g_k, gamma_p)


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of a 2x24 deep_blstm: both BLSTM kernels and both
    CTC kernels on the card against the plain path on the CPU."""
    g = torch.Generator().manual_seed(0)
    batch = [torch.randn(4, 30, 39, generator=g),
             torch.tensor([30, 22, 17, 9]),
             torch.randint(0, 27, (4, 6), generator=g),
             torch.tensor([6, 4, 5, 0]),
             torch.tensor([1.0, 1.0, 0.0, 1.0])]
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = deep_blstm("num_hiddens=24,num_layers=2,dropout=0.0",
                           generator=torch.Generator().manual_seed(1),
                           device=dev)
        trainer = Trainer(model, make_optimizer("adam", 1e-3, 1.0))
        counts = (bilstm.launches, bilstm_bwd.launches,
                  ctc.ctc_alpha.launches, ctc.ctc_beta.launches)
        _, m = trainer.train_step(trainer.init_state(),
                                  *[a.to(dev) for a in batch])
        launched = tuple(c1 - c0 for c0, c1 in zip(counts, (
            bilstm.launches, bilstm_bwd.launches, ctc.ctc_alpha.launches,
            ctc.ctc_beta.launches)))
        assert launched == ((2, 2, 1, 1) if dev.type == "cuda"
                            else (0, 0, 0, 0))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (loss_k, gn_k, g_k), (loss_p, gn_p, g_p) = out
    # chip_smoke.py's step bounds
    assert loss_k == pytest.approx(loss_p, rel=1e-4)
    assert gn_k == pytest.approx(gn_p, rel=1e-3)
    for k in g_p:
        assert float((g_k[k] - g_p[k]).norm()) <= 1e-3 * float(
            g_p[k].norm()), k


def test_dropout_train_step_on_card_is_seeded(cuda):
    """Dropout on the card draws from a CUDA torch.Generator: the same seed
    gives the same step, another seed another one."""
    g = torch.Generator().manual_seed(2)
    batch = [torch.randn(3, 20, 39, generator=g).to(cuda),
             torch.tensor([20, 15, 11], device=cuda),
             torch.randint(0, 27, (3, 4), generator=g).to(cuda),
             torch.tensor([4, 3, 2], device=cuda),
             torch.ones(3, device=cuda)]
    losses = []
    for seed in (5, 5, 6):
        model = deep_blstm("num_hiddens=16,num_layers=2,dropout=0.5",
                           generator=torch.Generator().manual_seed(0),
                           device=cuda)
        trainer = Trainer(model, make_optimizer("adam", 1e-3, 400.0))
        _, m = trainer.train_step(
            trainer.init_state(), *batch,
            torch.Generator(device=cuda).manual_seed(seed))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] != losses[2]


GRU_SIZES = [(12, 4, 8), (37, 5, 100), (50, 9, 256)]


def _gru_cases(sizes):
    """Parametrise (t, b, h, dead) over ``sizes`` (no dead row), the shapes
    ragged for the cluster tiling (LSTM_RAGGED: the same tiling with three
    gate columns a unit) and H=512 (the wide design); the ids of ``sizes``
    stay "t-b-h"."""
    cases = ([(*size, False) for size in sizes] + LSTM_RAGGED
             + [(20, 3, 512, True)])
    return pytest.mark.parametrize(
        "t,b,h,dead", cases,
        ids=[f"{t}-{b}-{h}" + ("-dead" if d else "") for t, b, h, d in cases])


def _gru_case(cuda, t, b, h, seed, dead=False):
    """xp_f, xp_b [T,B,3H], ragged mask (with ``dead``, the last row masked
    on every frame), wh_f, wh_b [H,3H] and two cotangents [T,B,H], on the
    card."""
    g = torch.Generator().manual_seed(seed)
    xp = [torch.randn(t, b, 3 * h, generator=g) for _ in range(2)]
    wh = [torch.randn(h, 3 * h, generator=g) / h ** 0.5 for _ in range(2)]
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    if dead:
        lengths[-1] = 0
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = [torch.randn(t, b, h, generator=g) for _ in range(2)]
    return ([a.to(cuda) for a in (xp[0], xp[1], mask, wh[0], wh[1])],
            [a.to(cuda) for a in dh])


def _gru_designs(wrappers, h, b):
    """-> per wrapper (launches, launches of the design gru_geometry gives
    its direction count)."""
    return [(w.launches, w.by_design[gru_geometry(
        h, b, 2 if w.__name__.startswith("bi") else 1).design])
        for w in wrappers]


def _one_more(before):
    return [(n + 1, d + 1) for n, d in before]


@_gru_cases(GRU_SIZES)
def test_gru_fwd_kernels_match_plain(cuda, t, b, h, dead):
    """bigru (two directions) and gru (one) against their plain loops, each
    in the design gru_geometry picks (H=512: wide); where a cluster design
    runs, gru_geometry's shared memory is the kernel's own and the card
    holds the launch's clusters at once."""
    args, _ = _gru_case(cuda, t, b, h, seed=h + t, dead=dead)
    before = _gru_designs((bigru, gru), h, b)
    got = bigru(*args)
    got_uni = gru(args[0], args[2], args[3])
    assert _gru_designs((bigru, gru), h, b) == _one_more(before)
    for ndir in (1, 2):
        geo = gru_geometry(h, b, ndir)
        if geo.design != "stream":
            smem, fit = gru_cluster_info(geo, b, h, False)
            assert smem == geo.smem_fwd
            assert fit >= geo.grid[1] * geo.grid[2]
    want = bigru_plain(*args)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("h_f", "h_b"), got, want):
        torch.testing.assert_close(g_, w_, **GRU_TOL, msg=name)
    torch.testing.assert_close(got_uni, want[0], **GRU_TOL)


@_gru_cases(GRU_SIZES)
def test_gru_bwd_kernels_match_plain(cuda, t, b, h, dead):
    """bigru_bwd and gru_bwd: dxp and dhp of each direction, each in the
    design gru_geometry picks (from the forward's res, which holds the h
    side of the pre-activations where the wide design runs), against the
    plain walks that recompute them, with the backward's shared memory
    held against the kernel's own where a cluster design runs."""
    args, dh = _gru_case(cuda, t, b, h, seed=h + t + 1, dead=dead)
    *hs, res = bigru(*args, residual=True)
    h_uni, res_uni = gru(args[0], args[2], args[3], residual=True)
    before = _gru_designs((bigru_bwd, gru_bwd), h, b)
    got = bigru_bwd(*args, *hs, *dh, res)
    got_uni = gru_bwd(args[0], args[2], args[3], h_uni, dh[0], res_uni)
    assert _gru_designs((bigru_bwd, gru_bwd), h, b) == _one_more(before)
    for ndir in (1, 2):
        geo = gru_geometry(h, b, ndir)
        if geo.design != "stream":
            smem, fit = gru_cluster_info(geo, b, h, True)
            assert smem == geo.smem_bwd
            assert fit >= geo.grid[1] * geo.grid[2]
    want = bigru_bwd_plain(*args, *hs, *dh)
    want_uni = gru_bwd_plain(args[0], args[2], args[3], hs[0], dh[0])
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("dxp_f", "dhp_f", "dxp_b", "dhp_b"), got, want):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)
    for name, g_, w_ in zip(("dxp", "dhp"), got_uni, want_uni):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


# the wide GRU design at H=512: B=32 in two directions (R=16) and one
# (R=8), ragged B=5, 9, 33 (a last row group of one row) and 48 (the most
# two directions take), a row masked on every frame, T=1
GRU_WIDE_CASES = [(64, 32, 2, False), (64, 32, 1, False), (40, 33, 2, True),
                  (40, 33, 1, True), (23, 5, 2, True), (30, 9, 2, True),
                  (17, 48, 2, False), (1, 5, 2, True), (1, 3, 1, False)]


@pytest.mark.parametrize("t,b,ndir,dead", GRU_WIDE_CASES,
                         ids=[f"{t}-{b}-{'bi' if n == 2 else 'uni'}"
                              + ("-dead" if d else "")
                              for t, b, n, d in GRU_WIDE_CASES])
def test_gru_wide_kernels_match_plain(cuda, t, b, ndir, dead):
    """The wide GRU design's forward (serving, and keeping the h side of
    the pre-activations) and its backward from that res against their plain
    versions at H=512, and against the plain walk that recomputes the
    product; the launches counted under the wide design; gru_geometry's
    shared memory is the kernels' own and the card holds the launch's
    clusters at once; the backward run twice is equal bit for bit."""
    h = 512
    args, dh = _gru_case(cuda, t, b, h, seed=t + b + ndir, dead=dead)
    geo = gru_geometry(h, b, ndir)
    assert geo.design == "wide"
    for backward, smem in ((False, geo.smem_fwd), (True, geo.smem_bwd)):
        got_smem, fit = gru_cluster_info(geo, b, h, backward)
        assert got_smem == smem
        assert fit >= geo.grid[1] * geo.grid[2]
    fwd, bwd = (bigru, bigru_bwd) if ndir == 2 else (gru, gru_bwd)
    before = [(w.launches, w.by_design["wide"]) for w in (fwd, bwd)]
    if ndir == 2:
        served = bigru(*args)
        *hs, res = bigru(*args, residual=True)
        want = bigru_plain(*args, keep_hg=True)
        runs = [bigru_bwd(*args, *hs, *dh, res) for _ in range(2)]
        want_d = bigru_bwd_res_plain(args[0], args[1], *res, *args[2:], *hs,
                                     *dh)
        want_r = bigru_bwd_plain(*args, *hs, *dh)
    else:
        xp, mask, wh = args[0], args[2], args[3]
        served = (gru(xp, mask, wh),)
        h_1, res = gru(xp, mask, wh, residual=True)
        hs = [h_1]
        want = gru_plain(xp, mask, wh, keep_hg=True)
        runs = [gru_bwd(xp, mask, wh, h_1, dh[0], res) for _ in range(2)]
        want_d = gru_bwd_res_plain(xp, *res, mask, wh, h_1, dh[0])
        want_r = gru_bwd_plain(xp, mask, wh, h_1, dh[0])
    assert [(w.launches, w.by_design["wide"]) for w in (fwd, bwd)] == [
        (n + 2, d + 2) for n, d in before]
    torch.cuda.synchronize()
    assert len(res) == ndir
    for k_, s_ in zip(hs, served):
        assert torch.equal(k_, s_)
    for g_, w_ in zip((*hs, *res), want):
        torch.testing.assert_close(g_, w_, **GRU_TOL)
    for g_, w_, r_ in zip(runs[0], want_d, want_r):
        torch.testing.assert_close(g_, w_, **BWD_TOL)
        torch.testing.assert_close(g_, r_, **BWD_TOL)
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    if dead:
        for d_ in runs[0]:
            assert not d_[:, b - 1].any()


# H=512 beyond the wide design's budget: B=49 in two directions and B=97
# in one take the stream design (csrc/gru_stream_{fwd,bwd}.cu)
GRU_STREAM_CASES = [(20, 49, 2), (12, 97, 1)]


@pytest.mark.parametrize("t,b,ndir", GRU_STREAM_CASES,
                         ids=[f"{t}-{b}-{'bi' if n == 2 else 'uni'}"
                              for t, b, n in GRU_STREAM_CASES])
def test_gru_stream_route_matches_plain(cuda, t, b, ndir):
    """At H=512 and a batch the wide design's clusters cannot hold, the GRU
    forward and backward run the stream design (counted under it, the
    forward's res empty) and agree with their plain versions."""
    h = 512
    args, dh = _gru_case(cuda, t, b, h, seed=t + b, dead=True)
    assert gru_geometry(h, b, ndir).design == "stream"
    fwd, bwd = (bigru, bigru_bwd) if ndir == 2 else (gru, gru_bwd)
    before = [dict(w.by_design) for w in (fwd, bwd)]
    if ndir == 2:
        *hs, res = bigru(*args, residual=True)
        got = bigru_bwd(*args, *hs, *dh, res)
        want = bigru_plain(*args)
        want_d = bigru_bwd_plain(*args, *hs, *dh)
    else:
        xp, mask, wh = args[0], args[2], args[3]
        h_1, res = gru(xp, mask, wh, residual=True)
        hs = [h_1]
        got = gru_bwd(xp, mask, wh, h_1, dh[0], res)
        want = (gru_plain(xp, mask, wh),)
        want_d = gru_bwd_plain(xp, mask, wh, h_1, dh[0])
    assert res == ()
    for w, was in zip((fwd, bwd), before):
        assert w.by_design == {**was, "stream": was["stream"] + 1}
    torch.cuda.synchronize()
    for g_, w_ in zip(hs, want):
        torch.testing.assert_close(g_, w_, **GRU_TOL)
    for g_, w_ in zip(got, want_d):
        torch.testing.assert_close(g_, w_, **BWD_TOL)


def _grads(fn, leaves, dh):
    leaves = [a.clone().requires_grad_() for a in leaves]
    outs = fn(*leaves)
    torch.autograd.backward(outs, dh[:len(outs)])
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256), (24, 5, 512)])
def test_gru_functions_match_autograd_on_card(cuda, t, b, h):
    """Gradients of xp and wh through BiGRUFunction and GRUFunction (both
    kernels each; at H=512 the wide ones, the backward from the forward's
    res) against autograd through the plain loops, on the card."""
    (xp_f, xp_b, mask, wh_f, wh_b), dh = _gru_case(cuda, t, b, h, seed=9)
    cases = {
        "bi": (lambda xf, xb, wf, wb: BiGRUFunction.apply(xf, xb, mask, wf,
                                                          wb),
               lambda xf, xb, wf, wb: bigru_plain(xf, xb, mask, wf, wb),
               (xp_f, xp_b, wh_f, wh_b)),
        "uni": (lambda x, w: (GRUFunction.apply(x, mask, w),),
                lambda x, w: (gru_plain(x, mask, w),), (xp_f, wh_f)),
    }
    for kind, (kernel_fn, plain_fn, leaves) in cases.items():
        for i, (g_, w_) in enumerate(zip(_grads(kernel_fn, leaves, dh),
                                         _grads(plain_fn, leaves, dh))):
            torch.testing.assert_close(g_, w_, **BWD_TOL, msg=f"{kind} {i}")


def test_deep_gru_slice_on_card_matches_cpu(cuda):
    """deep_gru serving: bigru_fwd once per layer, logits against the
    plain path on the CPU."""
    rng = np.random.RandomState(2)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32)
            for n in (9000, 4000, 6500)]
    chunk, cap, n_pad, _ = pack_batches(wavs, 3)
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = deep_gru("num_hiddens=24,num_layers=2", num_classes=27,
                         generator=torch.Generator().manual_seed(0),
                         device=dev).eval()
        before = bigru.launches
        out.append(serve_batch(model, featurizer("mfcc", dev),
                               torch.from_numpy(chunk).to(dev), 3, n_pad))
        assert bigru.launches - before == (2 if dev.type == "cuda" else 0)
    torch.testing.assert_close(out[0].logits.cpu(), out[1].logits, rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bi", "uni"])
def test_deep_gru_train_step_on_card_matches_cpu(cuda, bidirectional):
    """One train step of a 2x24 deep_gru: the GRU kernels and both CTC
    kernels on the card against the plain path on the CPU."""
    g = torch.Generator().manual_seed(0)
    batch = [torch.randn(4, 30, 39, generator=g),
             torch.tensor([30, 22, 17, 9]),
             torch.randint(0, 27, (4, 6), generator=g),
             torch.tensor([6, 4, 5, 0]),
             torch.tensor([1.0, 1.0, 0.0, 1.0])]
    fwd, bwd = (bigru, bigru_bwd) if bidirectional else (gru, gru_bwd)
    hp = (f"num_hiddens=24,num_layers=2,dropout=0.0,"
          f"bidirectional={str(bidirectional).lower()}")
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = deep_gru(hp, generator=torch.Generator().manual_seed(1),
                         device=dev)
        trainer = Trainer(model, make_optimizer("adam", 1e-3, 1.0))
        counts = (fwd.launches, bwd.launches)
        _, m = trainer.train_step(trainer.init_state(),
                                  *[a.to(dev) for a in batch])
        launched = (fwd.launches - counts[0], bwd.launches - counts[1])
        assert launched == ((2, 2) if dev.type == "cuda" else (0, 0))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (loss_k, gn_k, g_k), (loss_p, gn_p, g_p) = out
    assert loss_k == pytest.approx(loss_p, rel=1e-4)
    assert gn_k == pytest.approx(gn_p, rel=1e-3)
    for k in g_p:
        assert float((g_k[k] - g_p[k]).norm()) <= 1e-3 * float(
            g_p[k].norm()), k


LSTM_SIZES = [(12, 4, 8), (37, 5, 100), (50, 9, 256), (20, 3, 512)]


@_lstm_cases(LSTM_SIZES)
def test_lstm_kernels_match_plain(cuda, t, b, h, dead):
    """lstm (one direction of bilstm_fwd) and lstm_bwd (of bilstm_bwd)
    against their plain loops: h, c and dxp; H=100 has a gate width not a
    multiple of 32 and a last CTA of 9 units, H=512 takes the wide design
    (the backward from the gates the forward kept).  Where a cluster
    design runs, lstm_geometry's shared memory is the kernels' own and the
    card holds the launch's clusters at once."""
    args, dh = _bilstm_case(cuda, t, b, h, seed=h + t + 2, dead=dead)
    xp, mask, wh = args[0], args[2], args[3]
    before = (_count_design(lstm, h, b, 1), _count_design(lstm_bwd, h, b, 1),
              bilstm.launches)
    geo = lstm_geometry(h, b, 1)
    h_k, c_k, res = lstm(xp, mask, wh, residual=True)
    dxp = lstm_bwd(xp, mask, wh, h_k, c_k, dh[0], res)
    assert (_count_design(lstm, h, b, 1), _count_design(lstm_bwd, h, b, 1),
            bilstm.launches) == (
        (before[0][0] + 1, before[0][1] + 1),
        (before[1][0] + 1, before[1][1] + 1), before[2])
    if geo.design != "stream":
        for backward, smem in ((False, geo.smem_fwd), (True, geo.smem_bwd)):
            got_smem, fit = cluster_info(geo, b, h, backward)
            assert got_smem == smem
            assert fit >= geo.grid[1] * geo.grid[2]
    h_p, c_p = lstm_plain(xp, mask, wh)
    dxp_p = lstm_bwd_plain(xp, mask, wh, h_k, c_k, dh[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(h_k, h_p, rtol=0, atol=1e-4, msg="h")
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-4, msg="c")
    torch.testing.assert_close(dxp, dxp_p, **BWD_TOL, msg="dxp")


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256), (20, 5, 512)])
def test_lstm_function_matches_autograd_on_card(cuda, t, b, h):
    """Gradients of xp and wh through LSTMFunction (both kernels) against
    autograd through the plain loop, on the card."""
    (xp, _, mask, wh, _), dh = _bilstm_case(cuda, t, b, h, seed=11)
    got = _grads(lambda x, w: (LSTMFunction.apply(x, mask, w),), (xp, wh),
                 dh)
    want = _grads(lambda x, w: (lstm_plain(x, mask, w)[0],), (xp, wh), dh)
    for name, g_, w_ in zip(("dxp", "dwh"), got, want):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


# the wide design at H=512: deep_speech's B=32 in two directions (R=16)
# and one (R=8), ragged B=33 (a last row group of one row) and B=5, a row
# masked on every frame, T=1
WIDE_CASES = [(64, 32, 2, False), (64, 32, 1, False), (40, 33, 2, True),
              (40, 33, 1, True), (23, 5, 2, True), (1, 3, 1, False)]


@pytest.mark.parametrize("t,b,ndir,dead", WIDE_CASES,
                         ids=[f"{t}-{b}-{'bi' if n == 2 else 'uni'}"
                              + ("-dead" if d else "")
                              for t, b, n, d in WIDE_CASES])
def test_wide_kernels_match_plain(cuda, t, b, ndir, dead):
    """The wide design's forward (serving, and keeping the gates) and its
    backward from those gates against their plain versions at H=512; the
    launches counted under the wide design; lstm_geometry's shared memory
    is the kernels' own and the card holds the launch's clusters at once;
    the backward run twice from the same inputs is equal bit for bit."""
    h = 512
    args, dh = _bilstm_case(cuda, t, b, h, seed=t + b + ndir, dead=dead)
    geo = lstm_geometry(h, b, ndir)
    assert geo.design == "wide"
    for backward, smem in ((False, geo.smem_fwd), (True, geo.smem_bwd)):
        got_smem, fit = cluster_info(geo, b, h, backward)
        assert got_smem == smem
        assert fit >= geo.grid[1] * geo.grid[2]
    fwd, bwd = (bilstm, bilstm_bwd) if ndir == 2 else (lstm, lstm_bwd)
    before = (_count_design(fwd, h, b, ndir), _count_design(bwd, h, b, ndir))
    if ndir == 2:
        served = bilstm(*args)
        *res, saved = bilstm(*args, residual=True)
        want = bilstm_plain(*args, keep_gates=True)
        runs = [bilstm_bwd(*args, *res, *dh, saved) for _ in range(2)]
        want_d = bilstm_bwd_gates_plain(*saved, args[2], args[3], args[4],
                                        res[1], res[3], *dh)
    else:
        xp, mask, wh = args[0], args[2], args[3]
        served = lstm(xp, mask, wh)
        *res, saved = lstm(xp, mask, wh, residual=True)
        want = lstm_plain(xp, mask, wh, keep_gates=True)
        runs = [(lstm_bwd(xp, mask, wh, *res, dh[0], saved),)
                for _ in range(2)]
        want_d = (lstm_bwd_gates_plain(*saved, mask, wh, res[1], dh[0]),)
    assert (_count_design(fwd, h, b, ndir), _count_design(bwd, h, b, ndir)) \
        == ((before[0][0] + 2, before[0][1] + 2),
            (before[1][0] + 2, before[1][1] + 2))
    torch.cuda.synchronize()
    assert len(saved) == ndir
    for g_, s_ in zip(res, served):
        assert torch.equal(g_, s_)
    for g_, w_ in zip((*res, *saved), want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4)
    for g_, w_ in zip(runs[0], want_d):
        torch.testing.assert_close(g_, w_, **BWD_TOL)
    assert all(torch.equal(a, c) for a, c in zip(*runs))


# H=512 beyond the wide design's budget: B=49 in two directions and B=97
# in one take the stream design (csrc/lstm_stream_{fwd,bwd}.cu)
STREAM_CASES = [(20, 49, 2), (12, 97, 1)]


@pytest.mark.parametrize("t,b,ndir", STREAM_CASES,
                         ids=[f"{t}-{b}-{'bi' if n == 2 else 'uni'}"
                              for t, b, n in STREAM_CASES])
def test_lstm_stream_route_matches_plain(cuda, t, b, ndir):
    """At H=512 and a batch the wide design's clusters cannot hold, the
    forward and backward run the stream design (counted under it, the
    forward's res empty) and agree with their plain versions."""
    h = 512
    args, dh = _bilstm_case(cuda, t, b, h, seed=t + b, dead=True)
    assert lstm_geometry(h, b, ndir).design == "stream"
    fwd, bwd = (bilstm, bilstm_bwd) if ndir == 2 else (lstm, lstm_bwd)
    before = [dict(w.by_design) for w in (fwd, bwd)]
    if ndir == 2:
        *res, saved = bilstm(*args, residual=True)
        got = bilstm_bwd(*args, *res, *dh, saved)
        want = bilstm_plain(*args)
        want_d = bilstm_bwd_plain(*args, *res, *dh)
    else:
        xp, mask, wh = args[0], args[2], args[3]
        *res, saved = lstm(xp, mask, wh, residual=True)
        got = (lstm_bwd(xp, mask, wh, *res, dh[0], saved),)
        want = lstm_plain(xp, mask, wh)
        want_d = (lstm_bwd_plain(xp, mask, wh, *res, dh[0]),)
    assert saved == ()
    for w, was in zip((fwd, bwd), before):
        assert w.by_design == {**was, "stream": was["stream"] + 1}
    torch.cuda.synchronize()
    for g_, w_ in zip(res, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4)
    for g_, w_ in zip(got, want_d):
        torch.testing.assert_close(g_, w_, **BWD_TOL)


# plain-LSTM models beside deep_blstm: name, hparams, forward and backward
# wrapper, recurrent layers
LSTM_ZOO = [
    ("deep_blstm", "num_hiddens=24,num_layers=2,bidirectional=false",
     lstm, lstm_bwd, 2),
    ("highway_blstm", "num_hiddens=24,num_layers=2", bilstm, bilstm_bwd, 2),
    ("residual_blstm", "num_hiddens=24,num_layers=2,bidirectional=false",
     lstm, lstm_bwd, 2),
    ("deep_speech", "num_hiddens=24,input_dense=32", bilstm, bilstm_bwd, 1),
    # deep_speech at its own width: the wide design
    ("deep_speech", "num_hiddens=512,input_dense=32", bilstm, bilstm_bwd, 1),
    ("deep_speech", "num_hiddens=512,input_dense=32,bidirectional=false",
     lstm, lstm_bwd, 1),
]
LSTM_ZOO_IDS = ["deep_blstm_uni", "highway", "residual_uni", "deep_speech",
                "deep_speech_512", "deep_speech_512_uni"]


@pytest.mark.parametrize("name,hp,fwd,bwd,layers", LSTM_ZOO,
                         ids=LSTM_ZOO_IDS)
def test_lstm_zoo_slice_on_card_matches_cpu(cuda, name, hp, fwd, bwd,
                                            layers):
    """Serving each plain-LSTM model: its forward kernel once per layer,
    logits against the plain path on the CPU."""
    rng = np.random.RandomState(3)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32)
            for n in (9000, 4000, 6500)]
    chunk, cap, n_pad, _ = pack_batches(wavs, 3)
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = build_model(name, hp, num_classes=27,
                            generator=torch.Generator().manual_seed(0),
                            device=dev).eval()
        before = fwd.launches
        out.append(serve_batch(model, featurizer("mfcc", dev),
                               torch.from_numpy(chunk).to(dev), 3, n_pad))
        assert fwd.launches - before == (layers if dev.type == "cuda"
                                         else 0)
    torch.testing.assert_close(out[0].logits.cpu(), out[1].logits, rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("name,hp,fwd,bwd,layers", LSTM_ZOO,
                         ids=LSTM_ZOO_IDS)
def test_lstm_zoo_train_step_on_card_matches_cpu(cuda, name, hp, fwd, bwd,
                                                 layers):
    """One train step of each plain-LSTM model (dropout off): its LSTM
    kernels and both CTC kernels on the card against the plain path on the
    CPU."""
    g = torch.Generator().manual_seed(0)
    batch = [torch.randn(4, 30, 39, generator=g),
             torch.tensor([30, 22, 17, 9]),
             torch.randint(0, 27, (4, 6), generator=g),
             torch.tensor([6, 4, 5, 0]),
             torch.tensor([1.0, 1.0, 0.0, 1.0])]
    hp = hp + ",dropout=0.0,input_dropout=0.0"
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = build_model(name, hp, generator=torch.Generator().manual_seed(
            1), device=dev)
        trainer = Trainer(model, make_optimizer("adam", 1e-3, 1.0))
        counts = (fwd.launches, bwd.launches)
        _, m = trainer.train_step(trainer.init_state(),
                                  *[a.to(dev) for a in batch])
        launched = (fwd.launches - counts[0], bwd.launches - counts[1])
        assert launched == ((layers, layers) if dev.type == "cuda"
                            else (0, 0))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (loss_k, gn_k, g_k), (loss_p, gn_p, g_p) = out
    assert loss_k == pytest.approx(loss_p, rel=1e-4)
    assert gn_k == pytest.approx(gn_p, rel=1e-3)
    for k in g_p:
        assert float((g_k[k] - g_p[k]).norm()) <= 1e-3 * float(
            g_p[k].norm()), k


def _ln_case(cuda, t, b, h, seed, dead=False):
    """Both directions' LN-LSTM arguments (xpn, wh, gh, gc, bc; gains about
    1 and biases about 0, none exactly), a ragged mask (with ``dead``, the
    last row masked on every frame) and two cotangents, on the card ->
    (xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b),
    [dh_f, dh_b]."""
    g = torch.Generator().manual_seed(seed)

    def near(n, centre):
        return centre + 0.3 * torch.randn(n, generator=g)

    xpn = [torch.randn(t, b, 4 * h, generator=g) for _ in range(2)]
    wh = [torch.randn(h, 4 * h, generator=g) / h ** 0.5 for _ in range(2)]
    gh = [near(4 * h, 1.0) for _ in range(2)]
    gc = [near(h, 1.0) for _ in range(2)]
    bc = [near(h, 0.0) for _ in range(2)]
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    if dead:
        lengths[-1] = 0
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = [torch.randn(t, b, h, generator=g) for _ in range(2)]
    args = (xpn[0], xpn[1], mask, wh[0], wh[1], gh[0], gh[1], gc[0], gc[1],
            bc[0], bc[1])
    return [a.to(cuda) for a in args], [a.to(cuda) for a in dh]


# H=8, 100 and 256 take the cluster design, H=300 and 512 the stream design
# (ops/ln_lstm.py ln_geometry)
LN_SIZES = [(12, 4, 8), (37, 5, 100), (50, 9, 256), (3, 1, 300),
            (20, 3, 512)]


def _ln_cases(sizes):
    """Parametrise (t, b, h, dead) over ``sizes`` (no dead row) and the
    shapes ragged for the cluster tiling (LSTM_RAGGED: B=33, T=1, H=100,
    a row masked on every frame) and a dead row at H=300 (the stream
    design); the ids of ``sizes`` stay "t-b-h"."""
    cases = ([(*size, False) for size in sizes] + LSTM_RAGGED
             + [(9, 6, 300, True)])
    return pytest.mark.parametrize(
        "t,b,h,dead", cases,
        ids=[f"{t}-{b}-{h}" + ("-dead" if d else "") for t, b, h, d in cases])


def _ln_designs(wrappers, h, b):
    """-> per wrapper (launches, launches of the design ln_geometry gives
    its direction count)."""
    return [(w.launches, w.by_design[ln_geometry(
        h, b, 2 if w.__name__.startswith("bi") else 1).design])
        for w in wrappers]


def _ln_layout_is_the_kernels(h, b, backward):
    """Where the cluster design runs: ln_geometry's shared memory is the
    kernel's own and the card holds the launch's clusters at once."""
    for ndir in (1, 2):
        geo = ln_geometry(h, b, ndir)
        if geo.design == "cluster":
            smem, fit = ln_cluster_info(geo, b, h, backward)
            assert smem == (geo.smem_bwd if backward else geo.smem_fwd)
            assert fit >= geo.grid[1] * geo.grid[2]


@_ln_cases(LN_SIZES)
def test_ln_fwd_kernels_match_plain(cuda, t, b, h, dead):
    """bi_ln_lstm (two directions of ln_lstm_fwd) and ln_lstm (one) against
    their plain loops: h and raw c (chip_smoke.py's BILSTM_* bounds), each
    in the design ln_geometry picks."""
    args, _ = _ln_case(cuda, t, b, h, seed=h + t, dead=dead)
    xf, _, mask, whf, _, ghf, _, gcf, _, bcf, _ = args
    before = _ln_designs((bi_ln_lstm, ln_lstm), h, b)
    got = bi_ln_lstm(*args)
    got_uni = ln_lstm(xf, mask, whf, ghf, gcf, bcf)
    assert _ln_designs((bi_ln_lstm, ln_lstm), h, b) == _one_more(before)
    _ln_layout_is_the_kernels(h, b, False)
    want = bi_ln_lstm_plain(*args)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("h_f", "c_f", "h_b", "c_b", "h", "c"),
                            (*got, *got_uni), (*want, *want[:2])):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4, msg=name)


@_ln_cases(LN_SIZES)
def test_ln_bwd_kernels_match_plain(cuda, t, b, h, dead):
    """bi_ln_lstm_bwd and ln_lstm_bwd: dpre and dcn of each direction, each
    in the design ln_geometry picks, against the plain loops run in float64
    from the same inputs.  The fp32 plain loop is itself up to 1.4e-4 from
    that value here (40-33-256), as large as the tolerance's absolute part:
    the LN backward carries rounding down the chain, so two fp32 runs can
    part by more than the tolerance.  Each kernel is held to the exact
    function instead."""
    args, dh = _ln_case(cuda, t, b, h, seed=h + t + 1, dead=dead)
    xf, _, mask, whf, _, ghf, _, gcf, _, bcf, _ = args
    hc = bi_ln_lstm(*args)
    before = _ln_designs((bi_ln_lstm_bwd, ln_lstm_bwd), h, b)
    got = bi_ln_lstm_bwd(*args, *hc, *dh)
    uni = (xf, mask, whf, ghf, gcf, bcf, hc[0], hc[1], dh[0])
    got_uni = ln_lstm_bwd(*uni)
    assert _ln_designs((bi_ln_lstm_bwd, ln_lstm_bwd), h, b) == _one_more(
        before)
    _ln_layout_is_the_kernels(h, b, True)
    want = bi_ln_lstm_bwd_plain(*(a.double() for a in (*args, *hc, *dh)))
    want_uni = ln_lstm_bwd_plain(*(a.double() for a in uni))
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("dpre_f", "dcn_f", "dpre_b", "dcn_b", "dpre",
                             "dcn"), (*got, *got_uni),
                            (w.float() for w in (*want, *want_uni))):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


def test_ln_kernels_repeat_bit_for_bit(cuda):
    """bi_ln_lstm and bi_ln_lstm_bwd at H=256, B=32 (the cluster design,
    every statistic summed across the cluster in rank order), run twice on
    the same inputs: equal bit for bit."""
    args, dh = _ln_case(cuda, 60, 32, 256, seed=21, dead=True)
    hc = [bi_ln_lstm(*args) for _ in range(2)]
    grads = [bi_ln_lstm_bwd(*args, *hc[0], *dh) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*hc):
        assert torch.equal(a, b_)
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)


def test_ln_cluster_launch_refuses_what_is_not_resident(cuda):
    """A cluster grid the card cannot hold at once (R=1 at B=32 in two
    directions: 64 clusters of 8 CTAs) is refused with an error, for both
    kernels, and never falls back to another design."""
    args, dh = _ln_case(cuda, 4, 32, 256, seed=5)
    # [wh_f, wh_b], [gh_f, gh_b], [gc_f, gc_b], [bc_f, bc_b]
    vecs = [args[i:i + 2] for i in (3, 5, 7, 9)]
    too_many = Geometry("cluster", 8, 32, 1, (8, 32, 2), 0, 0)
    before = [(w.launches, dict(w.by_design)) for w in (bi_ln_lstm,
                                                        bi_ln_lstm_bwd)]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        launch_fwd(too_many, args[:2], args[2], *vecs)
    hc = bi_ln_lstm(*args)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        launch_bwd(too_many, args[:2], args[2], *vecs, list(hc[0::2]),
                   list(hc[1::2]), dh)
    after = [(w.launches, w.by_design) for w in (bi_ln_lstm, bi_ln_lstm_bwd)]
    assert after[1] == before[1]
    assert after[0][0] == before[0][0] + 1


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256)])
def test_ln_functions_match_autograd_on_card(cuda, t, b, h):
    """Gradients of xpn, wh, gh, gc and bc through BiLNLSTMFunction and
    LNLSTMFunction (both kernels each) against autograd through the plain
    loops, on the card.  Each within 1e-4 of its largest entry
    (chip_smoke.py's DWH_RTOL form), not elementwise: the two run separate
    forwards, and the LN backward amplifies their fp32 differences over
    time."""
    args, dh = _ln_case(cuda, t, b, h, seed=13)
    mask = args[2]
    leaves_bi = [a for i, a in enumerate(args) if i != 2]
    cases = {
        "bi": (lambda *a: BiLNLSTMFunction.apply(*a[:2], mask, *a[2:]),
               lambda *a: bi_ln_lstm_plain(*a[:2], mask, *a[2:])[0::2],
               leaves_bi),
        "uni": (lambda x, w, g1, g2, b1: (LNLSTMFunction.apply(
                    x, mask, w, g1, g2, b1),),
                lambda x, w, g1, g2, b1: (ln_lstm_plain(
                    x, mask, w, g1, g2, b1)[0],),
                leaves_bi[0::2]),
    }
    for kind, (kernel_fn, plain_fn, leaves) in cases.items():
        for i, (g_, w_) in enumerate(zip(_grads(kernel_fn, leaves, dh),
                                         _grads(plain_fn, leaves, dh))):
            err = float((g_ - w_).abs().max())
            assert err <= 1e-4 * float(w_.abs().max()), (kind, i, err)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_ln_blstm_on_card_matches_cpu(cuda, bidirectional):
    """ln_blstm: serving (its forward kernel once per layer, logits against
    the plain path on the CPU) and one train step (both LN kernels and both
    CTC kernels on the card against the plain step on the CPU)."""
    fwd, bwd = ((bi_ln_lstm, bi_ln_lstm_bwd) if bidirectional
                else (ln_lstm, ln_lstm_bwd))
    hp = (f"num_hiddens=24,num_layers=2,dropout=0.0,"
          f"bidirectional={str(bidirectional).lower()}")
    rng = np.random.RandomState(4)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32)
            for n in (9000, 4000, 6500)]
    chunk, cap, n_pad, _ = pack_batches(wavs, 3)
    g = torch.Generator().manual_seed(0)
    batch = [torch.randn(4, 30, 39, generator=g),
             torch.tensor([30, 22, 17, 9]),
             torch.randint(0, 27, (4, 6), generator=g),
             torch.tensor([6, 4, 5, 0]),
             torch.tensor([1.0, 1.0, 0.0, 1.0])]
    served, out = [], []
    for dev in (cuda, torch.device("cpu")):
        model = build_model("ln_blstm", hp, num_classes=27,
                            generator=torch.Generator().manual_seed(1),
                            device=dev)
        counts = (fwd.launches, bwd.launches)
        served.append(serve_batch(model.eval(), featurizer("mfcc", dev),
                                  torch.from_numpy(chunk).to(dev), 3, n_pad))
        trainer = Trainer(model.train(), make_optimizer("adam", 1e-3, 1.0))
        _, m = trainer.train_step(trainer.init_state(),
                                  *[a.to(dev) for a in batch])
        launched = (fwd.launches - counts[0], bwd.launches - counts[1])
        assert launched == ((4, 2) if dev.type == "cuda" else (0, 0))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    torch.testing.assert_close(served[0].logits.cpu(), served[1].logits,
                               rtol=0, atol=2e-3)
    (loss_k, gn_k, g_k), (loss_p, gn_p, g_p) = out
    assert loss_k == pytest.approx(loss_p, rel=1e-4)
    assert gn_k == pytest.approx(gn_p, rel=1e-3)
    for k in g_p:
        assert float((g_k[k] - g_p[k]).norm()) <= 1e-3 * float(
            g_p[k].norm()), k


def _two_identical_steps(cuda, name, hp, seed=3, compute_dtype=None):
    """Two train steps of ``name`` from the same weights, fresh Adam state,
    batch and generator seed (in ``compute_dtype``) -> [(loss, {param:
    grad}, {param: updated})] for each, all on the host."""
    g = torch.Generator().manual_seed(7)
    b, t, l_max = 16, 300, 40
    batch = [torch.randn(b, t, 39, generator=g),
             torch.randint(t // 2, t + 1, (b,), generator=g),
             torch.randint(0, 27, (b, l_max), generator=g),
             torch.randint(l_max // 2, l_max + 1, (b,), generator=g),
             torch.ones(b)]
    batch[1][0] = t
    runs = []
    for _ in range(2):
        model = build_model(name, hp, generator=torch.Generator().manual_seed(
            1), device=cuda)
        trainer = Trainer(model, make_optimizer("adam", 1e-3, 400.0),
                          compute_dtype=compute_dtype)
        _, m = trainer.train_step(
            trainer.init_state(), *[a.to(cuda) for a in batch],
            torch.Generator(device=cuda).manual_seed(seed))
        runs.append((m["loss"].cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: p.detach().cpu()
                      for k, p in model.named_parameters()}))
    return runs


def _bit_differences(runs) -> list:
    """The names of the tensors that differ in any bit between two runs,
    with their largest absolute difference."""
    (loss0, g0, p0), (loss1, g1, p1) = runs
    diff = [] if torch.equal(loss0, loss1) else [("loss", float(
        (loss0 - loss1).abs()))]
    for kind, a, b in (("grad", g0, g1), ("param", p0, p1)):
        diff += [(f"{kind} {k}", float((a[k] - b[k]).abs().max()))
                 for k in a if not torch.equal(a[k], b[k])]
    return diff


def test_deep_blstm_train_step_is_bit_reproducible(cuda):
    """Two identical train steps of deep_blstm 3x256 give bit-equal loss,
    gradients and updated weights."""
    runs = _two_identical_steps(cuda, "deep_blstm", "dropout=0.0")
    assert _bit_differences(runs) == []


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bi", "uni"])
def test_deep_gru_train_step_is_bit_reproducible(cuda, bidirectional):
    """Two identical train steps of deep_gru 3x256 (the cluster GRU kernels)
    give bit-equal loss, gradients and updated weights."""
    fwd = bigru if bidirectional else gru
    before = fwd.by_design["cluster"]
    runs = _two_identical_steps(
        cuda, "deep_gru",
        f"dropout=0.0,bidirectional={str(bidirectional).lower()}")
    assert fwd.by_design["cluster"] - before == 2 * 3
    assert _bit_differences(runs) == []


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bi", "uni"])
def test_deep_gru_512_train_step_is_bit_reproducible(cuda, bidirectional):
    """Two identical train steps of deep_gru 3x512 (the wide GRU kernels,
    the backward from the forward's res) give bit-equal loss, gradients and
    updated weights."""
    fwd, bwd = (bigru, bigru_bwd) if bidirectional else (gru, gru_bwd)
    before = (fwd.by_design["wide"], bwd.by_design["wide"])
    runs = _two_identical_steps(
        cuda, "deep_gru",
        f"num_hiddens=512,dropout=0.0,"
        f"bidirectional={str(bidirectional).lower()}")
    assert (fwd.by_design["wide"] - before[0],
            bwd.by_design["wide"] - before[1]) == (2 * 3, 2 * 3)
    assert _bit_differences(runs) == []


# the bfloat16-weight forms (train --bf16): cluster (H=8, 100, 256),
# wide (H=300, 512) and stream shapes (STREAM_CASES at H=512; B=64 in two
# directions at H=256 and 100, B=128 in one at H=256: train --bf16
# --batch_size 64 and a unidirectional B=128), bi and uni, ragged and with
# a dead row; |kernel - plain| <= atol + rtol * |plain| (chip_smoke.py
# BF16_ATOL / BF16_RTOL: both sides round h_prev and dpre to bfloat16, and
# an operand on a rounding boundary may round apart)
BF16_TOL = dict(rtol=5e-3, atol=5e-3)
BF16_STREAM_CASES = [(24, 64, 256, 2, False), (20, 64, 100, 2, True),
                     (16, 128, 256, 1, False)]
BF16_CASES = [(12, 4, 8, 2, False), (37, 5, 100, 1, True),
              (64, 32, 256, 2, False), (40, 33, 256, 1, True),
              (23, 5, 300, 2, True), (64, 32, 512, 2, False),
              (40, 33, 512, 1, True),
              *[(t, b, 512, n, True) for t, b, n in STREAM_CASES],
              *BF16_STREAM_CASES]


@pytest.mark.parametrize("t,b,h,ndir,dead", BF16_CASES,
                         ids=[f"{t}-{b}-{h}-{'bi' if n == 2 else 'uni'}"
                              + ("-dead" if d else "")
                              for t, b, h, n, d in BF16_CASES])
def test_bf16_kernels_match_plain(cuda, t, b, h, ndir, dead):
    """The bfloat16-weight forms of the forward and backward (cluster, wide
    or stream, by lstm_geometry) against their plain twins with the same
    bfloat16 wh, counted under ``<design>_bf16``; repeated bit for bit."""
    args, dh = _bilstm_case(cuda, t, b, h, seed=t + b + h, dead=dead)
    args[3], args[4] = args[3].to(torch.bfloat16), args[4].to(torch.bfloat16)
    design = lstm_geometry(h, b, ndir).design + "_bf16"
    fwd, bwd = (bilstm, bilstm_bwd) if ndir == 2 else (lstm, lstm_bwd)
    before = (fwd.by_design[design], bwd.by_design[design])
    runs = []
    for _ in range(2):
        if ndir == 2:
            *outs, res = bilstm(*args, residual=True)
            dxp = bilstm_bwd(*args, *outs, *dh, res)
        else:
            xp, mask, wh = args[0], args[2], args[3]
            *outs, res = lstm(xp, mask, wh, residual=True)
            dxp = (lstm_bwd(xp, mask, wh, *outs, dh[0], res),)
        runs.append((*outs, *res, *dxp))
    assert (fwd.by_design[design] - before[0],
            bwd.by_design[design] - before[1]) == (2, 2)
    if ndir == 2:
        want = bilstm_plain(*args, keep_gates=bool(res))
        want_d = (bilstm_bwd_gates_plain(*res, *args[2:5], outs[1], outs[3],
                                         *dh) if res else
                  bilstm_bwd_plain(*args, *outs, *dh))
    else:
        want = lstm_plain(xp, mask, wh, keep_gates=bool(res))
        want_d = ((lstm_bwd_gates_plain(*res, mask, wh, outs[1], dh[0]),)
                  if res else (lstm_bwd_plain(xp, mask, wh, *outs, dh[0]),))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    for g_, w_ in zip((*outs, *res, *runs[0][-ndir:]), (*want, *want_d)):
        torch.testing.assert_close(g_, w_, **BF16_TOL)


@pytest.mark.parametrize("name,hp,design", [
    ("deep_blstm", "dropout=0.0", "cluster_bf16"),
    ("deep_speech", "dropout=0.0,input_dropout=0.0", "wide_bf16")])
def test_bf16_train_step_is_bit_reproducible(cuda, name, hp, design):
    """Two identical bfloat16 train steps of deep_blstm 3x256 (the cluster
    forms) and deep_speech (the wide forms) give bit-equal loss, gradients
    and updated weights, the masters float32."""
    before = (bilstm.by_design[design], bilstm_bwd.by_design[design])
    runs = _two_identical_steps(cuda, name, hp,
                                compute_dtype=torch.bfloat16)
    layers = 3 if name == "deep_blstm" else 1
    assert (bilstm.by_design[design] - before[0],
            bilstm_bwd.by_design[design] - before[1]) == (2 * layers,
                                                          2 * layers)
    assert _bit_differences(runs) == []
    assert all(p.dtype == torch.float32 for p in runs[0][2].values())
    assert np.isfinite(float(runs[0][0]))


def test_bf16_train_step_on_card_matches_cpu(cuda):
    """One bfloat16 step of a small deep_blstm on the card (the kernels'
    bfloat16 forms) against the CPU's (their plain twins): the loss, and
    each gradient within 1e-2 of its max abs (an operand on a bfloat16
    rounding boundary may round apart)."""
    g = torch.Generator().manual_seed(5)
    b, t, l_max = 6, 60, 12
    batch = [torch.randn(b, t, 39, generator=g),
             torch.randint(t // 2, t + 1, (b,), generator=g),
             torch.randint(0, 27, (b, l_max), generator=g),
             torch.randint(l_max // 2, l_max + 1, (b,), generator=g),
             torch.ones(b)]
    out = []
    for dev in (cuda, "cpu"):
        model = build_model("deep_blstm", "num_hiddens=64,num_layers=2,"
                            "dropout=0.0", generator=torch.Generator()
                            .manual_seed(2), device=dev)
        tr = Trainer(model, make_optimizer("sgd", 1e-2, 400.0),
                     compute_dtype=torch.bfloat16)
        _, m = tr.train_step(tr.init_state(), *[a.to(dev) for a in batch])
        out.append((float(m["loss"]), {k: p.grad.cpu() for k, p in
                                       model.named_parameters()}))
    (loss_k, g_k), (loss_p, g_p) = out
    assert loss_k == pytest.approx(loss_p, rel=1e-3)
    for k in g_p:
        scale = float(g_p[k].abs().max())
        assert float((g_k[k] - g_p[k]).abs().max()) <= 1e-2 * scale, k


# the GRU's bfloat16-weight forms: cluster (H=8, 100, 256), wide (H=300,
# 512) and stream shapes (GRU_STREAM_CASES at H=512 and BF16_STREAM_CASES),
# bi and uni, ragged and with a dead row, at BF16_TOL
GRU_BF16_CASES = [(12, 4, 8, 2, False), (37, 5, 100, 1, True),
                  (64, 32, 256, 2, False), (40, 33, 256, 1, True),
                  (23, 5, 300, 2, True), (64, 32, 512, 2, False),
                  (40, 33, 512, 1, True),
                  *[(t, b, 512, n, True) for t, b, n in GRU_STREAM_CASES],
                  *BF16_STREAM_CASES]


@pytest.mark.parametrize("t,b,h,ndir,dead", GRU_BF16_CASES,
                         ids=[f"{t}-{b}-{h}-{'bi' if n == 2 else 'uni'}"
                              + ("-dead" if d else "")
                              for t, b, h, n, d in GRU_BF16_CASES])
def test_gru_bf16_kernels_match_plain(cuda, t, b, h, ndir, dead):
    """The GRU's bfloat16-weight forms of the forward (the wide one keeping
    the h side) and backward (cluster, wide or stream, by gru_geometry)
    against
    their plain twins with the same bfloat16 wh: h, the kept h side, dxp,
    dhp, and dwh (bfloat16) within 1e-2 of its max abs; counted under
    ``<design>_bf16``; repeated bit for bit."""
    args, dh = _gru_case(cuda, t, b, h, seed=t + b + h + 1, dead=dead)
    args[3], args[4] = args[3].to(torch.bfloat16), args[4].to(torch.bfloat16)
    design = gru_geometry(h, b, ndir).design + "_bf16"
    fwd, bwd = (bigru, bigru_bwd) if ndir == 2 else (gru, gru_bwd)
    xp, mask, wh = args[0], args[2], args[3]
    before = (fwd.by_design[design], bwd.by_design[design])
    runs = []
    for _ in range(2):
        if ndir == 2:
            *hs, res = bigru(*args, residual=True)
            d = bigru_bwd(*args, *hs, *dh, res)
        else:
            h_1, res = gru(xp, mask, wh, residual=True)
            hs = [h_1]
            d = gru_bwd(xp, mask, wh, h_1, dh[0], res)
        runs.append((*hs, *res, *d))
    assert (fwd.by_design[design] - before[0],
            bwd.by_design[design] - before[1]) == (2, 2)
    if ndir == 2:
        want = bigru_plain(*args, keep_hg=bool(res))
        want_d = (bigru_bwd_res_plain(args[0], args[1], *res, *args[2:], *hs,
                                      *dh) if res else
                  bigru_bwd_plain(*args, *hs, *dh))
    else:
        want = gru_plain(xp, mask, wh, keep_hg=bool(res))
        want = want if res else (want,)
        want_d = (gru_bwd_res_plain(xp, *res, mask, wh, hs[0], dh[0]) if res
                  else gru_bwd_plain(xp, mask, wh, hs[0], dh[0]))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    got = runs[0]
    for g_, w_ in zip(got, (*want, *want_d)):
        assert g_.dtype == torch.float32
        torch.testing.assert_close(g_, w_, **BF16_TOL)
    for i in range(ndir):
        k_ = gru_dwh(hs[i], got[-2 * ndir + 2 * i + 1], i == 1, args[3 + i])
        p_ = gru_dwh(hs[i], want_d[2 * i + 1], i == 1, args[3 + i])
        assert k_.dtype == torch.bfloat16
        scale = float(p_.float().abs().max())
        assert float((k_.float() - p_.float()).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("hp,design", [
    ("dropout=0.0", "cluster_bf16"),
    ("dropout=0.0,bidirectional=false", "cluster_bf16"),
    ("num_hiddens=512,dropout=0.0", "wide_bf16")],
    ids=["3x256-bi", "3x256-uni", "3x512-bi"])
def test_bf16_gru_train_step_is_bit_reproducible(cuda, hp, design):
    """Two identical bfloat16 train steps of deep_gru (3x256 bi and uni:
    the cluster forms; 3x512: the wide forms) give bit-equal loss,
    gradients and updated weights, the masters float32."""
    fwd, bwd = ((gru, gru_bwd) if "bidirectional=false" in hp
                else (bigru, bigru_bwd))
    before = (fwd.by_design[design], bwd.by_design[design])
    runs = _two_identical_steps(cuda, "deep_gru", hp,
                                compute_dtype=torch.bfloat16)
    assert (fwd.by_design[design] - before[0],
            bwd.by_design[design] - before[1]) == (2 * 3, 2 * 3)
    assert _bit_differences(runs) == []
    assert all(p.dtype == torch.float32 for p in runs[0][2].values())
    assert np.isfinite(float(runs[0][0]))


def test_bf16_gru_train_step_on_card_matches_cpu(cuda):
    """One bfloat16 step of a small deep_gru on the card (the GRU kernels'
    bfloat16 forms) against the CPU's (their plain twins): the loss, and
    each gradient within 1e-2 of its max abs."""
    g = torch.Generator().manual_seed(6)
    b, t, l_max = 6, 60, 12
    batch = [torch.randn(b, t, 39, generator=g),
             torch.randint(t // 2, t + 1, (b,), generator=g),
             torch.randint(0, 27, (b, l_max), generator=g),
             torch.randint(l_max // 2, l_max + 1, (b,), generator=g),
             torch.ones(b)]
    out = []
    for dev in (cuda, "cpu"):
        model = build_model("deep_gru", "num_hiddens=64,num_layers=2,"
                            "dropout=0.0", generator=torch.Generator()
                            .manual_seed(2), device=dev)
        tr = Trainer(model, make_optimizer("sgd", 1e-2, 400.0),
                     compute_dtype=torch.bfloat16)
        _, m = tr.train_step(tr.init_state(), *[a.to(dev) for a in batch])
        out.append((float(m["loss"]), {k: p.grad.cpu() for k, p in
                                       model.named_parameters()}))
    (loss_k, g_k), (loss_p, g_p) = out
    assert loss_k == pytest.approx(loss_p, rel=1e-3)
    for k in g_p:
        scale = float(g_p[k].abs().max())
        assert float((g_k[k] - g_p[k]).abs().max()) <= 1e-2 * scale, k


# the zoneout and MI LSTMs' bfloat16-weight forms: the cluster design at
# H=8, 100 and 256, bi and uni, ragged and with a dead row, at BF16_TOL
ZM_BF16_CASES = [(12, 4, 8, 2, False), (37, 5, 100, 1, True),
                 (64, 32, 256, 2, False), (40, 33, 256, 1, True),
                 (29, 7, 256, 2, True)]
# and their stream design: B=64 in two directions at H=256 and 100, B=128
# in one at H=256 (train --bf16 --batch_size 64, a unidirectional B=128),
# H=300 and H=512 at small batches; a list of its own, since the LN LSTM's
# bfloat16 cases (LN_BF16_CASES) are ZM_BF16_CASES and its stream design
# has a list of its own (LN_BF16_STREAM_CASES)
ZM_BF16_STREAM_CASES = [(24, 64, 256, 2, False), (20, 64, 100, 2, True),
                        (16, 128, 256, 1, False), (23, 5, 300, 1, True),
                        (12, 3, 512, 2, True)]


def _zm_bf16_case(cuda, cell, t, b, h, dead):
    """(bidirectional arguments with bfloat16 wh, the unidirectional ones,
    dh) of the zoneout (Bernoulli(0.9) mix) or MI LSTM, the last row dead
    where ``dead``."""
    seed = t + b + h + 2
    if cell == "zoneout":
        args, dh = _zoneout_case(cuda, t, b, h, seed, "bernoulli")
        w_at, pick = (7, 8), _zo_uni
    else:
        args, dh = _mi_case(cuda, t, b, h, seed)
        w_at, pick = (3, 4), _mi_uni
    if dead:
        args[2] = args[2].clone()
        args[2][:, -1] = 0.0
    for i in w_at:
        args[i] = args[i].to(torch.bfloat16)
    return args, pick(args), dh


def _zm_ops(cell, ndir):
    """(forward, backward, forward plain, backward plain) of one cell."""
    if cell == "zoneout":
        return ((bi_zoneout_lstm, bi_zoneout_lstm_bwd, bi_zoneout_lstm_plain,
                 bi_zoneout_lstm_bwd_plain) if ndir == 2 else
                (zoneout_lstm, zoneout_lstm_bwd, zoneout_lstm_plain,
                 zoneout_lstm_bwd_plain))
    return ((bi_mi_lstm, bi_mi_lstm_bwd, bi_mi_lstm_plain,
             bi_mi_lstm_bwd_plain) if ndir == 2 else
            (mi_lstm, mi_lstm_bwd, mi_lstm_plain, mi_lstm_bwd_plain))


def _zm_dwh(cell, ndir, args, hc, d, i):
    """dwh (bfloat16) of direction i from the backward's output d."""
    from asr_study_torch.ops.bilstm import _dwh
    from asr_study_torch.ops.mi_lstm import dir_grads

    if cell == "zoneout":
        wh = args[7 + i] if ndir == 2 else args[4]
        return _dwh(hc[2 * i], d[i], i == 1, wh)
    if ndir == 2:
        xp, wh, al, b1, b2 = (args[i], args[3 + i], args[5 + i], args[7 + i],
                              args[9 + i])
    else:
        xp, _, wh, al, b1, b2, _ = args
    return dir_grads(d[i], xp, hc[2 * i], wh, al, b1, b2, i == 1)[1]


@pytest.mark.parametrize("cell", ["zoneout", "mi"])
@pytest.mark.parametrize("t,b,h,ndir,dead",
                         ZM_BF16_CASES + ZM_BF16_STREAM_CASES,
                         ids=[f"{t}-{b}-{h}-{'bi' if n == 2 else 'uni'}"
                              + ("-dead" if d else "")
                              for t, b, h, n, d in
                              ZM_BF16_CASES + ZM_BF16_STREAM_CASES])
def test_zoneout_mi_bf16_kernels_match_plain(cuda, cell, t, b, h, ndir,
                                             dead):
    """The zoneout and MI LSTMs' bfloat16-weight forms of the forward and
    backward (the cluster design, and the stream design at
    ZM_BF16_STREAM_CASES) against their plain twins with the same bfloat16
    wh: h, c, dxp / dpre at BF16_TOL, dwh (bfloat16) within 1e-2 of its
    max abs; counted under ``<design>_bf16``; repeated bit for bit."""
    bi_args, uni_args, dh = _zm_bf16_case(cuda, cell, t, b, h, dead)
    args = bi_args if ndir == 2 else uni_args
    dh = dh[:ndir]
    geometry = zoneout_geometry if cell == "zoneout" else mi_geometry
    design = ("stream" if (t, b, h, ndir, dead) in ZM_BF16_STREAM_CASES
              else "cluster")
    assert geometry(h, b, ndir).design == design
    key = design + "_bf16"
    fwd, bwd, fwd_plain, bwd_plain = _zm_ops(cell, ndir)
    before = (fwd.by_design[key], bwd.by_design[key])
    runs = []
    for _ in range(2):
        hc = fwd(*args)
        d = bwd(*args, *hc, *dh)
        d = d if isinstance(d, tuple) else (d,)
        runs.append((*hc, *d))
    assert (fwd.by_design[key] - before[0],
            bwd.by_design[key] - before[1]) == (2, 2)
    want = fwd_plain(*args)
    want_d = bwd_plain(*args, *hc, *dh)
    want_d = want_d if isinstance(want_d, tuple) else (want_d,)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    for g_, w_ in zip(runs[0], (*want, *want_d)):
        assert g_.dtype == torch.float32
        torch.testing.assert_close(g_, w_, **BF16_TOL)
    for i in range(ndir):
        k_ = _zm_dwh(cell, ndir, args, hc, d, i)
        p_ = _zm_dwh(cell, ndir, args, hc, want_d, i)
        assert k_.dtype == torch.bfloat16
        scale = float(p_.float().abs().max())
        assert float((k_.float() - p_.float()).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("name,bidirectional", [
    ("zoneout_blstm", True), ("zoneout_blstm", False), ("mi_blstm", True),
    ("mi_blstm", False)], ids=["zoneout-bi", "zoneout-uni", "mi-bi",
                               "mi-uni"])
def test_bf16_zoneout_mi_train_step_is_bit_reproducible(cuda, name,
                                                       bidirectional):
    """Two identical bfloat16 train steps of zoneout_blstm (rate 0.1, the
    mix drawn from the same seed) and mi_blstm, 3x256 bi and uni (the
    cluster forms), give bit-equal loss, gradients and updated weights,
    the masters float32."""
    if name == "zoneout_blstm":
        ops = ((bi_zoneout_lstm, bi_zoneout_lstm_bwd) if bidirectional else
               (zoneout_lstm, zoneout_lstm_bwd))
    else:
        ops = ((bi_mi_lstm, bi_mi_lstm_bwd) if bidirectional else
               (mi_lstm, mi_lstm_bwd))
    before = [w.by_design["cluster_bf16"] for w in ops]
    runs = _two_identical_steps(
        cuda, name, f"dropout=0.0,bidirectional={str(bidirectional).lower()}",
        compute_dtype=torch.bfloat16)
    assert [w.by_design["cluster_bf16"] - n for w, n in zip(ops, before)] \
        == [2 * 3, 2 * 3]
    assert _bit_differences(runs) == []
    assert all(p.dtype == torch.float32 for p in runs[0][2].values())
    assert np.isfinite(float(runs[0][0]))


def _host_mix(seed):
    """A ZoneoutLSTMCell.mix drawing Bernoulli(0.9) weights from one CPU
    generator and moving them to the caller's device: a run on the card
    and one on the CPU get the same mix."""
    g = torch.Generator().manual_seed(seed)

    def mix(self, t_steps, batch, train=False, generator=None, device=None):
        shape = (t_steps, batch, self.hidden)
        return tuple((torch.rand(shape, generator=g) < 0.9).float().to(device)
                     for _ in range(2))
    return mix


@pytest.mark.parametrize("name", ["zoneout_blstm", "mi_blstm"])
def test_bf16_zoneout_mi_train_step_on_card_matches_cpu(cuda, monkeypatch,
                                                        name):
    """One bfloat16 step of a small zoneout_blstm (the mix drawn on the
    host for both) and mi_blstm on the card (the kernels' bfloat16 forms)
    against the CPU's (their plain twins): the loss, and each gradient
    within 1e-2 of its max abs."""
    g = torch.Generator().manual_seed(8)
    b, t, l_max = 6, 60, 12
    batch = [torch.randn(b, t, 39, generator=g),
             torch.randint(t // 2, t + 1, (b,), generator=g),
             torch.randint(0, 27, (b, l_max), generator=g),
             torch.randint(l_max // 2, l_max + 1, (b,), generator=g),
             torch.ones(b)]
    out = []
    for dev in (cuda, "cpu"):
        monkeypatch.setattr(ZoneoutLSTMCell, "mix", _host_mix(9))
        model = build_model(name, "num_hiddens=64,num_layers=2,dropout=0.0",
                            generator=torch.Generator().manual_seed(2),
                            device=dev)
        tr = Trainer(model, make_optimizer("sgd", 1e-2, 400.0),
                     compute_dtype=torch.bfloat16)
        _, m = tr.train_step(tr.init_state(), *[a.to(dev) for a in batch])
        out.append((float(m["loss"]), {k: p.grad.cpu() for k, p in
                                       model.named_parameters()}))
    (loss_k, g_k), (loss_p, g_p) = out
    assert loss_k == pytest.approx(loss_p, rel=1e-3)
    for k in g_p:
        scale = float(g_p[k].abs().max())
        assert float((g_k[k] - g_p[k]).abs().max()) <= 1e-2 * scale, k


# the layer-norm LSTM's bfloat16-weight forms: the cluster design at H=8,
# 100 and 256, bi and uni, ragged and with a dead row.  The forward frame
# by frame at BF16_TOL (ROADMAP C2; the whole sequences part where a
# bfloat16 rounding of h_prev flips between kernel and twin);
# the backward per (frame, row) within BF16_TOL's atol + LN_BF16_ROW_RTOL
# of the row's norm and dwh within LN_BF16_DWH_FRAC of its max, on T <= 64
# or the first 64 steps of a chain: a bfloat16 rounding of dhp that flips
# between two summation orders moves the chain by more than BF16_TOL (the
# twin against itself in another order, tests/test_torch_bf16_ln.py
# test_ln_bf16_backward_spread_*; chip_smoke.py LN_BF16_ROW_RTOL)
LN_BF16_CASES = ZM_BF16_CASES
LN_BF16_ROW_RTOL = 0.1
LN_BF16_DWH_FRAC = 3e-2


def _rows_within(got, want, rtol):
    """Every (frame, row): ||got - want|| <= BF16_TOL's atol + rtol *
    ||want||."""
    diff = (got - want).norm(dim=-1)
    return bool((diff <= BF16_TOL["atol"] + rtol * want.norm(dim=-1)).all())


def _ln_bf16_args(cuda, t, b, h, seed, dead, ndir):
    """An LN case (_ln_case) with bfloat16 wh, in the op's order for
    ``ndir`` directions, and its cotangents."""
    args, dh = _ln_case(cuda, t, b, h, seed=seed, dead=dead)
    args = list(args)
    args[3], args[4] = args[3].to(torch.bfloat16), args[4].to(torch.bfloat16)
    if ndir == 1:
        args = [args[i] for i in (0, 2, 3, 5, 7, 9)]
    return args, dh[:ndir]


def _ln_bf16_ops(ndir):
    return ((bi_ln_lstm, bi_ln_lstm_bwd, bi_ln_lstm_plain,
             bi_ln_lstm_bwd_plain) if ndir == 2 else
            (ln_lstm, ln_lstm_bwd, ln_lstm_plain, ln_lstm_bwd_plain))


def _ln_steps(args, hc, ndir):
    """The plain step from the kernel's own previous state at every frame
    (h, c per direction): the forward held frame by frame."""
    from asr_study_torch.models.cells import ln_lstm_step
    from asr_study_torch.ops.recurrence import prev

    xs, mask, vecs = args[:ndir], args[ndir], args[ndir + 1:]
    out = []
    for d in range(ndir):
        wh, gh, gc, bc = vecs[d::ndir]
        h_k, c_k = hc[2 * d], hc[2 * d + 1]
        t, b, h = h_k.shape
        h_s, c_s = ln_lstm_step(
            prev(h_k, d == 1).reshape(t * b, h),
            prev(c_k, d == 1).reshape(t * b, h),
            xs[d].reshape(t * b, 4 * h), mask.reshape(t * b, 1), wh, gh, gc,
            bc)
        out += [h_s.view_as(h_k), c_s.view_as(c_k)]
    return out


def _check_ln_bf16(cuda, t, b, h, ndir, dead, design):
    """The LN LSTM's bfloat16-weight forms of the forward and backward of
    ``design`` against their plain twins with the same bfloat16 wh: h and
    c of every frame against the plain step from the kernel's own state at
    BF16_TOL, dpre and dcn (from the same forward states) per (frame, row)
    within LN_BF16_ROW_RTOL of the row's norm, dwh (bfloat16) within
    LN_BF16_DWH_FRAC of its max abs; counted under ``<design>_bf16``;
    repeated bit for bit."""
    from asr_study_torch.ops.ln_lstm import _ln_param_grads

    args, dh = _ln_bf16_args(cuda, t, b, h, t + b + h + 3, dead, ndir)
    assert ln_geometry(h, b, ndir).design == design
    fwd, bwd, _, bwd_plain = _ln_bf16_ops(ndir)
    key = f"{design}_bf16"
    before = (fwd.by_design[key], bwd.by_design[key])
    runs = []
    for _ in range(2):
        hc = fwd(*args)
        runs.append((*hc, *bwd(*args, *hc, *dh)))
    assert (fwd.by_design[key] - before[0],
            bwd.by_design[key] - before[1]) == (2, 2)
    want = _ln_steps(args, hc, ndir)
    want_d = bwd_plain(*args, *hc, *dh)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    for g_, w_ in zip(runs[0][:2 * ndir], want):
        assert g_.dtype == torch.float32
        torch.testing.assert_close(g_, w_, **BF16_TOL)
    d = runs[0][2 * ndir:]
    for g_, w_ in zip(d, want_d):
        assert g_.dtype == torch.float32
        assert _rows_within(g_, w_, LN_BF16_ROW_RTOL)
    for i in range(ndir):
        wh, gh = args[ndir + 1 + i], args[ndir + 1 + ndir + i]
        k_, p_ = (_ln_param_grads(g[2 * i], g[2 * i + 1], hc[2 * i],
                                  hc[2 * i + 1], wh, gh, i == 1)[0]
                  for g in (d, want_d))
        assert k_.dtype == torch.bfloat16
        scale = float(p_.float().abs().max())
        assert float((k_.float() - p_.float()).abs().max()) <= \
            LN_BF16_DWH_FRAC * scale


@pytest.mark.parametrize("t,b,h,ndir,dead", LN_BF16_CASES,
                         ids=[f"{t}-{b}-{h}-{'bi' if n == 2 else 'uni'}"
                              + ("-dead" if d else "")
                              for t, b, h, n, d in LN_BF16_CASES])
def test_ln_bf16_kernels_match_plain(cuda, t, b, h, ndir, dead):
    """_check_ln_bf16 of the cluster design."""
    _check_ln_bf16(cuda, t, b, h, ndir, dead, "cluster")


@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_ln_bf16_kernels_stepwise_at_long_t(cuda, ndir):
    """At T=512, B=32, H=256 (the training shapes, where the LN recurrence
    is chaotic, ROADMAP C2) the bfloat16 forward's h and c of every frame
    against the plain step from the kernel's own previous state at
    BF16_TOL; the backward's dpre and dcn of every (frame, row) of the
    first 64 steps of each chain within LN_BF16_ROW_RTOL of that row's
    norm against the twin's from the same states, and finite on every
    frame."""
    args, dh = _ln_bf16_args(cuda, 512, 32, 256, 41, False, ndir)
    fwd, bwd, _, bwd_plain = _ln_bf16_ops(ndir)
    hc = fwd(*args)
    steps = _ln_steps(args, hc, ndir)
    d_k = bwd(*args, *hc, *dh)
    d_p = bwd_plain(*args, *hc, *dh)
    torch.cuda.synchronize()
    for g_, w_ in zip(hc, steps):
        torch.testing.assert_close(g_, w_, **BF16_TOL)
    for i, (g_, w_) in enumerate(zip(d_k, d_p)):
        assert bool(torch.isfinite(g_).all())
        # the chain starts at the last frame forward, the first reversed
        head = slice(-64, None) if i < 2 else slice(None, 64)
        assert _rows_within(g_[head], w_[head], LN_BF16_ROW_RTOL)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_bf16_ln_train_step_is_bit_reproducible(cuda, bidirectional):
    """Two identical bfloat16 train steps of ln_blstm 3x256, bi and uni (the
    cluster forms), give bit-equal loss, gradients and updated weights,
    the masters float32."""
    ops = ((bi_ln_lstm, bi_ln_lstm_bwd) if bidirectional else
           (ln_lstm, ln_lstm_bwd))
    before = [w.by_design["cluster_bf16"] for w in ops]
    hp = f"dropout=0.0,bidirectional={str(bidirectional).lower()}"
    runs = _two_identical_steps(cuda, "ln_blstm", hp,
                                compute_dtype=torch.bfloat16)
    assert [w.by_design["cluster_bf16"] - n for w, n in zip(ops, before)] \
        == [2 * 3, 2 * 3]
    assert _bit_differences(runs) == []
    assert all(p.dtype == torch.float32 for p in runs[0][2].values())
    assert np.isfinite(float(runs[0][0]))


# the LN LSTM's bfloat16 stream forms: (H, B, directions) at the shapes
# that go to the stream design: H=300 and 512 at small batches, a batch
# past the cluster budget at H=100, and train --bf16 --batch_size 64's
# B=64 in two directions and a unidirectional B=128 at H=256; T and a dead
# last row by case
LN_BF16_STREAM_CASES = [(300, 2, 1), (512, 3, 2), (100, 49, 2), (256, 64, 2),
                        (256, 128, 1)]


@pytest.mark.parametrize("h,b,ndir", LN_BF16_STREAM_CASES)
def test_ln_bf16_stream_shapes_refuse_on_card(cuda, h, b, ndir):
    """At the shapes ln_geometry sends to the stream design a bfloat16 LN
    call runs the stream design's bfloat16-weight forms, refusing none:
    _check_ln_bf16 of the stream design."""
    _check_ln_bf16(cuda, 20 + h % 7, b, h, ndir, b % 2 == 1, "stream")


def test_deep_blstm_train_step_is_bit_reproducible_deterministic(cuda):
    """The same under ``torch.use_deterministic_algorithms``, switched on
    for this test only: the control that separates a nondeterministic
    library op from the port's own code."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = _two_identical_steps(cuda, "deep_blstm", "dropout=0.0")
    finally:
        torch.use_deterministic_algorithms(before)
    assert _bit_differences(runs) == []


# H=8, 100 and 256 take the cluster design (B=32 at H=256: R=4 rows a
# cluster in one direction, R=8 in two), H=300 the stream design; B=49 at
# H=100 the stream design in two directions (no row count keeps the launch
# within the budget) and the cluster one at R=8 in one
# (ops/zoneout_lstm.py zoneout_geometry)
ZO_SIZES = [(12, 4, 8), (37, 5, 100), (50, 9, 256), (3, 1, 300),
            (40, 32, 256), (37, 49, 100)]


def _zoneout_case(cuda, t, b, h, seed, mix):
    """Both directions' zoneout-LSTM arguments in the port's order (xp_f,
    xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b) with Bernoulli(0.9) or
    constant 0.9 mix weights, a ragged mask and two cotangents, on the
    card."""
    g = torch.Generator().manual_seed(seed)
    xp = [torch.randn(t, b, 4 * h, generator=g) for _ in range(2)]
    wh = [torch.randn(h, 4 * h, generator=g) / h ** 0.5 for _ in range(2)]
    if mix == "bernoulli":
        z = [(torch.rand(t, b, h, generator=g) < 0.9).float()
             for _ in range(4)]
    else:
        z = [torch.full((t, b, h), 0.9) for _ in range(4)]
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = [torch.randn(t, b, h, generator=g) for _ in range(2)]
    args = (xp[0], xp[1], mask, *z, wh[0], wh[1])
    return [a.to(cuda) for a in args], [a.to(cuda) for a in dh]


def _zo_uni(args):
    return [args[i] for i in (0, 2, 3, 5, 7)]


def _zo_designs(wrappers, h, b):
    """-> per wrapper (launches, launches of the design zoneout_geometry
    gives its direction count)."""
    return [(w.launches, w.by_design[zoneout_geometry(
        h, b, 2 if w.__name__.startswith("bi") else 1).design])
        for w in wrappers]


@pytest.mark.parametrize("mix", ["bernoulli", "constant"])
@pytest.mark.parametrize("t,b,h", ZO_SIZES)
def test_zoneout_kernels_match_plain(cuda, t, b, h, mix):
    """bi_zoneout_lstm and zoneout_lstm (the zoneout_lstm_fwd kernel with
    two and one directions) and their backwards against the plain loops,
    each in the design zoneout_geometry picks (where that is the cluster
    one, with the kernels' own shared memory and every cluster resident at
    once): mixed h and c (chip_smoke.py's BILSTM_* bounds), dxp
    (BWD_TOL)."""
    args, dh = _zoneout_case(cuda, t, b, h, t + h, mix)
    uni = _zo_uni(args)
    wrappers = (bi_zoneout_lstm, zoneout_lstm, bi_zoneout_lstm_bwd,
                zoneout_lstm_bwd)
    before = _zo_designs(wrappers, h, b)
    got = bi_zoneout_lstm(*args)
    got_uni = zoneout_lstm(*uni)
    d = bi_zoneout_lstm_bwd(*args, *got, *dh)
    d_uni = zoneout_lstm_bwd(*uni, *got_uni, dh[0])
    assert _zo_designs(wrappers, h, b) == _one_more(before)
    for ndir in (1, 2):
        geo = zoneout_geometry(h, b, ndir)
        if geo.design == "cluster":
            for backward in (False, True):
                smem, fit = zoneout_cluster_info(geo, b, h, backward)
                assert smem == (geo.smem_bwd if backward else geo.smem_fwd)
                assert fit >= geo.grid[1] * geo.grid[2]
    want = bi_zoneout_lstm_plain(*args)
    want_d = bi_zoneout_lstm_bwd_plain(*args, *got, *dh)
    want_d_uni = zoneout_lstm_bwd_plain(*uni, *got_uni, dh[0])
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("h_f", "c_f", "h_b", "c_b", "h", "c"),
                            (*got, *got_uni), (*want, *want[:2])):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4, msg=name)
    for name, g_, w_ in zip(("dxp_f", "dxp_b", "dxp"), (*d, d_uni),
                            (*want_d, want_d_uni)):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


def test_zoneout_kernels_repeat_bit_for_bit(cuda):
    """bi_zoneout_lstm and bi_zoneout_lstm_bwd at H=256, B=32 (the cluster
    design, every sum in a fixed order), and zoneout_lstm and
    zoneout_lstm_bwd, each run twice on the same inputs with Bernoulli mix
    weights: equal bit for bit."""
    args, dh = _zoneout_case(cuda, 60, 32, 256, 23, "bernoulli")
    uni = _zo_uni(args)
    assert {zoneout_geometry(256, 32, n).design for n in (1, 2)} == {
        "cluster"}
    hc = [bi_zoneout_lstm(*args) for _ in range(2)]
    grads = [bi_zoneout_lstm_bwd(*args, *hc[0], *dh) for _ in range(2)]
    hc_uni = [zoneout_lstm(*uni) for _ in range(2)]
    grads_uni = [zoneout_lstm_bwd(*uni, *hc_uni[0], dh[0]) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*hc):
        assert torch.equal(a, b_)
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)
    for a, b_ in zip(*hc_uni):
        assert torch.equal(a, b_)
    assert torch.equal(*grads_uni)


def test_zoneout_cluster_launch_refuses_what_is_not_resident(cuda):
    """A cluster grid the card cannot hold at once (R=1 at B=32 in two
    directions: 64 clusters of 8 CTAs) is refused with an error, for both
    kernels, and never falls back to another design."""
    args, dh = _zoneout_case(cuda, 4, 32, 256, 5, "bernoulli")
    too_many = Geometry("cluster", 8, 32, 1, (8, 32, 2), 0, 0)
    before = [(w.launches, dict(w.by_design)) for w in (bi_zoneout_lstm,
                                                        bi_zoneout_lstm_bwd)]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        zo_launch_fwd(too_many, args[:2], args[2], args[3:5], args[5:7],
                      args[7:])
    hc = bi_zoneout_lstm(*args)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        zo_launch_bwd(too_many, args[:2], args[2], args[3:5], args[5:7],
                      args[7:], list(hc[0::2]), list(hc[1::2]), dh)
    after = [(w.launches, w.by_design) for w in (bi_zoneout_lstm,
                                                 bi_zoneout_lstm_bwd)]
    assert after[1] == before[1]
    assert after[0][0] == before[0][0] + 1


def test_zoneout_rate_zero_kernel_is_the_lstm_kernel(cuda):
    """zh = zc = 1: zoneout_lstm_fwd gives what bilstm_fwd gives, in two
    directions and in one (the cluster design of both at H=256), and the
    backward's dxp from the same h and c is bilstm_bwd's (BWD_TOL)."""
    args, dh = _zoneout_case(cuda, 40, 6, 256, 3, "constant")
    ones = torch.ones_like(args[3])
    xps, mask, whs = args[:2], args[2], args[7:]
    assert {zoneout_geometry(256, 6, n).design for n in (1, 2)} == {
        lstm_geometry(256, 6, n).design for n in (1, 2)} == {"cluster"}
    got = bi_zoneout_lstm(*xps, mask, ones, ones, ones, ones, *whs)
    want = bilstm(*xps, mask, *whs)
    got_uni = zoneout_lstm(xps[0], mask, ones, ones, whs[0])
    want_uni = lstm(xps[0], mask, whs[0])
    d = bi_zoneout_lstm_bwd(*xps, mask, ones, ones, ones, ones, *whs, *want,
                            *dh)
    d_want = bilstm_bwd(*xps, mask, *whs, *want, *dh)
    d_uni = zoneout_lstm_bwd(xps[0], mask, ones, ones, whs[0], *want_uni,
                             dh[0])
    d_uni_want = lstm_bwd(xps[0], mask, whs[0], *want_uni, dh[0])
    torch.cuda.synchronize()
    for g_, w_ in zip((*got, *got_uni), (*want, *want_uni)):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
    for name, g_, w_ in zip(("dxp_f", "dxp_b", "dxp"), (*d, d_uni),
                            (*d_want, d_uni_want)):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256)])
def test_zoneout_functions_match_autograd_on_card(cuda, t, b, h):
    """Gradients of xp and wh through BiZoneoutLSTMFunction and
    ZoneoutLSTMFunction against autograd through the plain loops, with
    Bernoulli mix weights, each within 1e-4 of its largest entry."""
    args, dh = _zoneout_case(cuda, t, b, h, 17, "bernoulli")
    mask, z = args[2], args[3:7]
    cases = {
        "bi": (lambda xf, xb, wf, wb: BiZoneoutLSTMFunction.apply(
                   xf, xb, mask, *z, wf, wb),
               lambda xf, xb, wf, wb: bi_zoneout_lstm_plain(
                   xf, xb, mask, *z, wf, wb)[0::2],
               [args[0], args[1], args[7], args[8]]),
        "uni": (lambda x, w: (ZoneoutLSTMFunction.apply(x, mask, z[0], z[2],
                                                        w),),
                lambda x, w: (zoneout_lstm_plain(x, mask, z[0], z[2], w)[0],),
                [args[0], args[7]]),
    }
    for kind, (kernel_fn, plain_fn, leaves) in cases.items():
        for i, (g_, w_) in enumerate(zip(_grads(kernel_fn, leaves, dh),
                                         _grads(plain_fn, leaves, dh))):
            err = float((g_ - w_).abs().max())
            assert err <= 1e-4 * float(w_.abs().max()), (kind, i, err)


# H=8, 100 and 256 take the cluster design (B=32: R=4 rows a cluster in
# one direction, R=8 in two; B=33: a ragged last group), H=300 the stream
# design (ops/mi_lstm.py mi_geometry)
MI_SIZES = [(12, 4, 8), (37, 5, 100), (50, 9, 256), (3, 1, 300),
            (60, 32, 256), (20, 33, 100)]


def _mi_case(cuda, t, b, h, seed):
    """Both directions' MI-LSTM arguments in the port's order (xp_f, xp_b,
    mask, wh_f, wh_b, alpha_*, beta1_*, beta2_*, b_*; the scales about 1),
    a ragged mask and two cotangents, on the card."""
    g = torch.Generator().manual_seed(seed)
    xp = [torch.randn(t, b, 4 * h, generator=g) for _ in range(2)]
    wh = [torch.randn(h, 4 * h, generator=g) / h ** 0.5 for _ in range(2)]
    vecs = [c + 0.3 * torch.randn(4 * h, generator=g)
            for c in (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0)]
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = [torch.randn(t, b, h, generator=g) for _ in range(2)]
    args = (xp[0], xp[1], mask, wh[0], wh[1], *vecs)
    return [a.to(cuda) for a in args], [a.to(cuda) for a in dh]


def _mi_uni(args):
    return [args[i] for i in (0, 2, 3, 5, 7, 9, 11)]


def _mi_designs(wrappers, h, b):
    """-> per wrapper (launches, launches of the design mi_geometry gives
    its direction count)."""
    return [(w.launches, w.by_design[mi_geometry(
        h, b, 2 if w.__name__.startswith("bi") else 1).design])
        for w in wrappers]


@pytest.mark.parametrize("t,b,h", MI_SIZES)
def test_mi_kernels_match_plain(cuda, t, b, h):
    """bi_mi_lstm and mi_lstm (the mi_lstm_fwd kernel with two and one
    directions) and their backwards against the plain loops, each in the
    design mi_geometry picks (where that is the cluster one, with the
    kernels' own shared memory and every cluster resident at once): h and
    c (chip_smoke.py's BILSTM_* bounds), dpre (BWD_TOL)."""
    args, dh = _mi_case(cuda, t, b, h, t + h)
    uni = _mi_uni(args)
    wrappers = (bi_mi_lstm, mi_lstm, bi_mi_lstm_bwd, mi_lstm_bwd)
    before = _mi_designs(wrappers, h, b)
    got = bi_mi_lstm(*args)
    got_uni = mi_lstm(*uni)
    d = bi_mi_lstm_bwd(*args, *got, *dh)
    d_uni = mi_lstm_bwd(*uni, *got_uni, dh[0])
    assert _mi_designs(wrappers, h, b) == _one_more(before)
    for ndir in (1, 2):
        geo = mi_geometry(h, b, ndir)
        if geo.design == "cluster":
            for backward in (False, True):
                smem, fit = mi_cluster_info(geo, b, h, backward)
                assert smem == (geo.smem_bwd if backward else geo.smem_fwd)
                assert fit >= geo.grid[1] * geo.grid[2]
    want = bi_mi_lstm_plain(*args)
    want_d = bi_mi_lstm_bwd_plain(*args, *got, *dh)
    want_d_uni = mi_lstm_bwd_plain(*uni, *got_uni, dh[0])
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("h_f", "c_f", "h_b", "c_b", "h", "c"),
                            (*got, *got_uni), (*want, *want[:2])):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4, msg=name)
    for name, g_, w_ in zip(("dpre_f", "dpre_b", "dpre"), (*d, d_uni),
                            (*want_d, want_d_uni)):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


def test_mi_kernels_repeat_bit_for_bit(cuda):
    """bi_mi_lstm and bi_mi_lstm_bwd at H=256, B=32 (the cluster design,
    every sum in a fixed order), and mi_lstm and mi_lstm_bwd, each run twice
    on the same inputs: equal bit for bit."""
    args, dh = _mi_case(cuda, 60, 32, 256, seed=21)
    uni = _mi_uni(args)
    assert mi_geometry(256, 32, 2).design == "cluster"
    hc = [bi_mi_lstm(*args) for _ in range(2)]
    grads = [bi_mi_lstm_bwd(*args, *hc[0], *dh) for _ in range(2)]
    hc_uni = [mi_lstm(*uni) for _ in range(2)]
    grads_uni = [mi_lstm_bwd(*uni, *hc_uni[0], dh[0]) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*hc):
        assert torch.equal(a, b_)
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)
    for a, b_ in zip(*hc_uni):
        assert torch.equal(a, b_)
    assert torch.equal(*grads_uni)


def test_mi_cluster_launch_refuses_what_is_not_resident(cuda):
    """A cluster grid the card cannot hold at once (R=1 at B=32 in two
    directions: 64 clusters of 8 CTAs) is refused with an error, for both
    kernels, and never falls back to another design."""
    args, dh = _mi_case(cuda, 4, 32, 256, seed=5)
    too_many = Geometry("cluster", 8, 32, 1, (8, 32, 2), 0, 0)
    before = [(w.launches, dict(w.by_design)) for w in (bi_mi_lstm,
                                                        bi_mi_lstm_bwd)]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        mi_launch_fwd(too_many, args[:2], args[2], args[3:5], args[5:])
    hc = bi_mi_lstm(*args)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        mi_launch_bwd(too_many, args[:2], args[2], args[3:5], args[5:],
                      list(hc[0::2]), list(hc[1::2]), dh)
    after = [(w.launches, w.by_design) for w in (bi_mi_lstm, bi_mi_lstm_bwd)]
    assert after[1] == before[1]
    assert after[0][0] == before[0][0] + 1


@pytest.mark.parametrize("t,b,h", [(40, 32, 256), (37, 5, 100)])
def test_mi_at_alpha_zero_is_the_lstm_kernel(cuda, t, b, h):
    """At alpha = 0 and beta1 = beta2 = 1 the MI pre-activation is the
    LSTM's, xp + hp + b: bi_mi_lstm and mi_lstm match the cluster bilstm
    and lstm kernels fed xp + b (chip_smoke.py's BILSTM_* bounds), and the
    MI backward's dpre matches bilstm_bwd's dxp from the same h and c
    (BWD_TOL)."""
    args, dh = _mi_case(cuda, t, b, h, seed=t + h + 2)
    xps, mask, whs, b_vecs = args[:2], args[2], args[3:5], args[11:13]
    ones = torch.ones_like(b_vecs[0])
    mi_args = (*xps, mask, *whs, ones * 0, ones * 0, ones, ones, ones, ones,
               *b_vecs)
    lstm_xps = [x + bv for x, bv in zip(xps, b_vecs)]
    assert lstm_geometry(h, b, 2).design == mi_geometry(h, b, 2).design
    got = bi_mi_lstm(*mi_args)
    want = bilstm(*lstm_xps, mask, *whs)
    got_uni = mi_lstm(*_mi_uni(mi_args))
    want_uni = lstm(lstm_xps[0], mask, whs[0])
    d = bi_mi_lstm_bwd(*mi_args, *want, *dh)
    d_want = bilstm_bwd(*lstm_xps, mask, *whs, *want, *dh)
    d_uni = mi_lstm_bwd(*_mi_uni(mi_args), *want_uni, dh[0])
    d_uni_want = lstm_bwd(lstm_xps[0], mask, whs[0], *want_uni, dh[0])
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("h_f", "c_f", "h_b", "c_b", "h", "c"),
                            (*got, *got_uni), (*want, *want_uni)):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4, msg=name)
    for name, g_, w_ in zip(("dpre_f", "dpre_b", "dpre"), (*d, d_uni),
                            (*d_want, d_uni_want)):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256)])
def test_mi_functions_match_autograd_on_card(cuda, t, b, h):
    """Gradients of xp, wh, alpha, beta1, beta2 and b through
    BiMILSTMFunction and MILSTMFunction against autograd through the plain
    loops, each within 1e-4 of its largest entry."""
    args, dh = _mi_case(cuda, t, b, h, 19)
    mask = args[2]
    leaves_bi = [a for i, a in enumerate(args) if i != 2]
    cases = {
        "bi": (lambda *a: BiMILSTMFunction.apply(*a[:2], mask, *a[2:]),
               lambda *a: bi_mi_lstm_plain(*a[:2], mask, *a[2:])[0::2],
               leaves_bi),
        "uni": (lambda x, w, *v: (MILSTMFunction.apply(x, mask, w, *v),),
                lambda x, w, *v: (mi_lstm_plain(x, mask, w, *v)[0],),
                leaves_bi[0::2]),
    }
    for kind, (kernel_fn, plain_fn, leaves) in cases.items():
        for i, (g_, w_) in enumerate(zip(_grads(kernel_fn, leaves, dh),
                                         _grads(plain_fn, leaves, dh))):
            err = float((g_ - w_).abs().max())
            assert err <= 1e-4 * float(w_.abs().max()), (kind, i, err)


def _same_masks(monkeypatch):
    """Zoneout mix weights shared by two train-mode runs: the first run's
    draws are recorded in order (layer by layer, forward cell first) in
    ``drawn``; once they are moved to ``replay``, the next run is handed
    the same ones on its own device.  Eval mode is left alone."""
    drawn, replay = [], []
    real = ZoneoutLSTMCell.mix

    def mix(cell, t_steps, batch, train=False, generator=None, device=None):
        if train and replay:
            return tuple(z.to(device) for z in replay.pop(0))
        out = real(cell, t_steps, batch, train, generator, device)
        if train:
            drawn.append(out)
        return out

    monkeypatch.setattr(ZoneoutLSTMCell, "mix", mix)
    return drawn, replay


@pytest.mark.parametrize("name", ["zoneout_blstm", "mi_blstm"])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_zoneout_and_mi_blstm_on_card_match_cpu(cuda, monkeypatch, name,
                                                bidirectional):
    """zoneout_blstm (eval mode serving, then a train step at rates 0.1
    with masks drawn on the card from a CUDA generator and handed to the
    CPU step) and mi_blstm: serving (the forward kernel once per layer,
    logits against the plain path on the CPU) and one train step (both
    kernels of the model and both CTC kernels on the card against the plain
    step on the CPU)."""
    kernels = {"zoneout_blstm": ((bi_zoneout_lstm, bi_zoneout_lstm_bwd),
                                 (zoneout_lstm, zoneout_lstm_bwd)),
               "mi_blstm": ((bi_mi_lstm, bi_mi_lstm_bwd),
                            (mi_lstm, mi_lstm_bwd))}
    fwd, bwd = kernels[name][0 if bidirectional else 1]
    hp = (f"num_hiddens=24,num_layers=2,dropout=0.0,"
          f"bidirectional={str(bidirectional).lower()}")
    rng = np.random.RandomState(4)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32)
            for n in (9000, 4000, 6500)]
    chunk, cap, n_pad, _ = pack_batches(wavs, 3)
    g = torch.Generator().manual_seed(0)
    batch = [torch.randn(4, 30, 39, generator=g),
             torch.tensor([30, 22, 17, 9]),
             torch.randint(0, 27, (4, 6), generator=g),
             torch.tensor([6, 4, 5, 0]),
             torch.tensor([1.0, 1.0, 0.0, 1.0])]
    drawn, replay = _same_masks(monkeypatch)
    served, out = [], []
    for dev in (cuda, torch.device("cpu")):
        model = build_model(name, hp, num_classes=27,
                            generator=torch.Generator().manual_seed(1),
                            device=dev)
        counts = (fwd.launches, bwd.launches)
        served.append(serve_batch(model.eval(), featurizer("mfcc", dev),
                                  torch.from_numpy(chunk).to(dev), 3, n_pad))
        trainer = Trainer(model.train(), make_optimizer("adam", 1e-3, 1.0))
        _, m = trainer.train_step(trainer.init_state(),
                                  *[a.to(dev) for a in batch],
                                  torch.Generator(device=dev).manual_seed(2))
        if dev.type == "cuda":
            replay.extend(drawn)
        launched = (fwd.launches - counts[0], bwd.launches - counts[1])
        assert launched == ((4, 2) if dev.type == "cuda" else (0, 0))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    if name == "zoneout_blstm":
        assert not replay and len(drawn) == 2 * (2 if bidirectional else 1)
        assert all(z.device.type == "cuda" and 0.0 < float(z.mean()) < 1.0
                   for pair in drawn for z in pair)
    torch.testing.assert_close(served[0].logits.cpu(), served[1].logits,
                               rtol=0, atol=2e-3)
    (loss_k, gn_k, g_k), (loss_p, gn_p, g_p) = out
    assert loss_k == pytest.approx(loss_p, rel=1e-4)
    assert gn_k == pytest.approx(gn_p, rel=1e-3)
    for k in g_p:
        assert float((g_k[k] - g_p[k]).norm()) <= 1e-3 * float(
            g_p[k].norm()), k


def test_cli_train_and_eval_on_card(cuda, tmp_path, monkeypatch, capsys):
    """make_dataset -> train one epoch -> eval through the CLIs on the card
    at a small size: the recurrence and CTC kernels launch, and every
    tensor a train step is handed lies on the card."""
    from asr_study_torch.cli import eval as cli_eval
    from asr_study_torch.cli import make_dataset
    from asr_study_torch.cli import train as cli_train

    monkeypatch.chdir(tmp_path)
    assert make_dataset.main(["--parser", "synthwords", "--dataset_dir",
                              "corpus", "--corpus_params",
                              '{"n": 40, "seed": 1}', "--to_json",
                              "m.json"]) == 0
    devices = set()
    real_step = Trainer.train_step

    def train_step(self, state, *args):
        devices.update(a.device.type for a in args
                       if isinstance(a, torch.Tensor))
        devices.update(p.device.type for p in self.model.parameters())
        return real_step(self, state, *args)

    monkeypatch.setattr(Trainer, "train_step", train_step)
    wrappers = (bilstm, bilstm_bwd, ctc.ctc_alpha, ctc.ctc_beta)
    before = [w.launches for w in wrappers]
    assert cli_train.main(["--dataset", "m.json", "--model", "deep_blstm",
                           "--params", "num_hiddens=32,num_layers=2",
                           "--epochs", "1", "--batch_size", "8",
                           "--save", "run"]) == 0
    trained = [w.launches - b for w, b in zip(wrappers, before)]
    assert all(n > 0 for n in trained), trained
    assert devices == {"cuda"}
    before = [w.launches for w in wrappers]
    assert cli_eval.main(["--dataset", "m.json", "--split", "valid",
                          "--batch_size", "8", "--save", "run"]) == 0
    evals = [w.launches - b for w, b in zip(wrappers, before)]
    assert evals[0] > 0 and evals[2] > 0 and evals[1] == evals[3] == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open("run/meta.json") as f:
        val_loss = json.load(f)["history"][-1]["val_loss"]
    assert out["num_utts"] == 4 and np.isfinite(out["loss"])
    assert out["loss"] == pytest.approx(val_loss, rel=1e-5)


# -- the beam decode (csrc/ctc_beam.cu) --------------------------------------

def _beam_emissions(cuda, seed=0, batch=6, t_max=160, vocab=28):
    """chip_smoke.py's beam emissions at a small size: randn, the blank
    column +10 on 65% of frames and -10 on the rest; lengths T but on the
    last rows (ragged, one of them 0)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, t_max, vocab).astype(np.float32)
    x[:, :, -1] += np.where(rng.rand(batch, t_max) < 0.65, 10.0,
                            -10.0).astype(np.float32)
    lens = np.full(batch, t_max, np.int32)
    lens[-3:] = [rng.randint(1, t_max), 1, 0]
    return torch.from_numpy(x).to(cuda), torch.from_numpy(lens).to(cuda)


def _beam_lm(seed=0, n_char=27):
    rng = np.random.RandomState(seed)
    return fit_ngram_lm([rng.randint(0, n_char, size=rng.randint(1, 30))
                         for _ in range(100)], 3, n_char, n_char - 1)


@pytest.mark.parametrize("width,prune,collapse,with_lm,vocab", [
    (4, 0, False, False, 28), (16, 0, False, False, 28),
    (64, 0, False, False, 28), (64, 8, False, False, 28),
    (16, 0, True, False, 28), (16, 0, False, True, 28),
    (256, 0, False, False, 28), (16, 0, False, False, 100),
    (128, 0, False, False, 100), (129, 8, False, False, 65),
    (160, 0, False, True, 70), (256, 0, False, True, 28)],
    ids=["w4", "w16", "w64", "w64_prune8", "w16_collapse", "w16_lm3",
         "wide_w256", "wide_w16_v100", "wide_w128_v100",
         "wide_w129_v65_prune8", "wide_w160_v70_lm3", "wide_w256_lm3"])
def test_beam_kernel_matches_plain(cuda, width, prune, collapse, with_lm,
                                   vocab):
    """Every beam of the kernel against the plain twin on the card, on
    chip_smoke.py's cases, on the select design and (W > 128 or V > 64)
    the wide one: the same prefixes and lengths, the scores bit for bit
    (the same arithmetic, no FMA contraction), one launch of the design
    beam_design picks."""
    logits, lens = _beam_emissions(cuda, vocab=vocab)
    if collapse:
        logits, lens, _ = ctc.blank_collapse(logits, lens, threshold=0.99)
    lp = torch.log_softmax(logits, -1)
    lm = _beam_lm(0, vocab - 1) if with_lm else None
    kw = dict(prune=prune, lm=lm, lm_alpha=0.8, lm_beta=0.1)
    design = beam.beam_design(width, vocab)
    before = dict(beam.ctc_beam.by_design)
    got = beam.ctc_beam(lp, lens, width, top_paths=width, **kw)
    assert beam.ctc_beam.by_design == {**before,
                                       design: before[design] + 1}
    want = beam.beam_search_plain(lp, lens, width, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    assert int(got[1][-1, 0]) == 0 and float(got[2][-1, 0]) == 0.0


@pytest.mark.parametrize("width,prune", [(16, 0), (64, 8)])
def test_beam_kernel_lane1_collisions(cuda, monkeypatch, width, prune):
    """Lane 1 of the hash patched to a multiplier of 0 (every two prefixes
    with the same last char collide in it; the kernel reads the multiplier
    at each call): the merge's lane-1 step and lane-2 check must still
    find exactly the twin's matches, so every beam is bit-equal."""
    monkeypatch.setattr(beam, "_HASH_MULT", 0)
    logits, lens = _beam_emissions(cuda, seed=1)
    lp = torch.log_softmax(logits, -1)
    got = beam.ctc_beam(lp, lens, width, top_paths=width, prune=prune)
    want = beam.beam_search_plain(lp, lens, width, prune=prune)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("width,with_lm", [(16, True), (128, False)],
                         ids=["w16_lm3", "w128"])
def test_beam_kernel_long_rows(cuda, width, with_lm):
    """T=805 (the serving slices' frames) with rows of length 0 and 1, at
    W=16 with the LM and at W=128 (16 warps, four keys a lane in each
    warp's list): the first four beams bit-equal to the twin's."""
    logits, lens = _beam_emissions(cuda, seed=2, batch=5, t_max=805)
    lp = torch.log_softmax(logits, -1)
    kw = dict(lm=_beam_lm(), lm_alpha=0.8, lm_beta=0.1) if with_lm else {}
    got = beam.ctc_beam(lp, lens, width, top_paths=4, **kw)
    want = beam.beam_search_plain(lp, lens, width, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w[:, :4])
    assert sorted(lens.tolist())[:2] == [0, 1]
    assert int(got[1][-1, 0]) == 0 and float(got[2][-1, 0]) == 0.0


def test_beam_kernel_limits(cuda):
    """Past the select design's W <= 128 and V <= 64 the wide design runs
    (csrc/ctc_beam_wide.cu), never the plain twin: W=129, V=65, and
    W=1024 at V=256 with a 3-gram LM through ctc_beam and
    beam_search_decode, each equal to the twin; at W=128, V=64 the select
    design runs and equals it."""
    cases = [(129, 28, None, 4, 12), (4, 65, None, 4, 12),
             (1024, 256, _beam_lm(3, 255), 4, 6)]
    for width, vocab, lm, batch, t_max in cases:
        logits, lens = _beam_emissions(cuda, seed=width, batch=batch,
                                       t_max=t_max, vocab=vocab)
        lp = torch.log_softmax(logits, -1)
        kw = dict(lm=lm, lm_alpha=0.8, lm_beta=0.1)
        assert beam.beam_design(width, vocab) == "wide"
        before = dict(beam.ctc_beam.by_design)
        got = beam.ctc_beam(lp, lens, width, top_paths=width, **kw)
        dec = beam.beam_search_decode(logits, lens, beam_width=width,
                                      top_paths=2, **kw)
        assert beam.ctc_beam.by_design == {"select": before["select"],
                                           "wide": before["wide"] + 2}
        want = beam.beam_search_plain(lp, lens, width, **kw)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w)
        for g, w in zip(dec, want):
            assert torch.equal(g, w[:, :2])
    logits, lens = _beam_emissions(cuda, batch=4, t_max=12, vocab=64)
    lp = torch.log_softmax(logits, -1)
    before = beam.ctc_beam.by_design["select"]
    got = beam.ctc_beam(lp, lens, 128, top_paths=128)
    assert beam.ctc_beam.by_design["select"] == before + 1
    want = beam.beam_search_plain(lp, lens, 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("width,vocab", [(256, 28), (129, 65)])
def test_beam_wide_kernel_repeats_bit_for_bit(cuda, width, vocab):
    """The wide design's candidate lists are filled by atomics in no fixed
    order; the selection by unique keys makes two runs bit-equal."""
    logits, lens = _beam_emissions(cuda, seed=5, batch=4, t_max=64,
                                   vocab=vocab)
    lp = torch.log_softmax(logits, -1)
    one = beam.ctc_beam(lp, lens, width, top_paths=width, prune=12)
    for _ in range(2):
        again = beam.ctc_beam(lp, lens, width, top_paths=width, prune=12)
        for a, b in zip(one, again):
            assert torch.equal(a, b)


def test_beam_cuda_input_never_reaches_the_plain_twin(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA input reached beam_search_plain")

    logits, lens = _beam_emissions(cuda, batch=3, t_max=40)
    want = beam.beam_search_plain(torch.log_softmax(logits, -1), lens, 8)
    monkeypatch.setattr(beam, "beam_search_plain", refuse)
    before = beam.ctc_beam.launches
    dec, dlens, scores = beam.beam_search_decode(logits, lens, beam_width=8,
                                                 top_paths=3)
    assert beam.ctc_beam.launches == before + 1
    assert dec.device.type == "cuda" and dec.shape == (3, 3, 40)
    assert torch.equal(dec, want[0][:, :3])
    assert torch.equal(scores, want[2][:, :3])


# -- the HDF5 path and in-step device features -------------------------------

def test_featurized_train_step_on_card_matches_cpu(cuda):
    """A train step on raw waveforms with the kernel featurizer on the
    card against the same step with the plain featurizer on the CPU, from
    the same weights: loss and grad norm rel 1e-4, the fbank kernel
    launched once."""
    from asr_study_torch.features.augment import SpecAugment, WavAugment

    rng = np.random.RandomState(5)
    n = 24576
    lens = np.array([n, 20000, 16384, 9000], np.int32)
    wavs = (0.2 * rng.randn(4, n)).astype(np.float32)
    wavs[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    labels = rng.randint(0, 27, (4, 16)).astype(np.int32)
    batch = (wavs[..., None], lens, labels, np.full(4, 12, np.int32),
             np.ones(4, np.float32))
    out = {}
    for dev in ("cpu", cuda):
        model = deep_blstm("num_hiddens=64,num_layers=2,dropout=0.0",
                           num_classes=27, input_dim=39,
                           generator=torch.Generator().manual_seed(0),
                           device=dev)
        trainer = Trainer(model, make_optimizer(),
                          featurizer=featurizer("mfcc", dev))
        state = trainer.init_state()
        before = fbank.launches
        _, m = trainer.train_step(state, *[torch.from_numpy(a).to(dev)
                                           for a in batch])
        out[str(dev)] = {k: float(v) for k, v in m.items()}
        if dev != "cpu":
            assert fbank.launches - before == 1
    for k in ("loss", "grad_norm"):
        assert out["cuda:0"][k] == pytest.approx(out["cpu"][k], rel=1e-4)
    # with both augmentations on the card: finite, and repeatable
    losses = []
    for _ in range(2):
        model = deep_blstm("num_hiddens=64,num_layers=2", num_classes=27,
                           input_dim=39,
                           generator=torch.Generator().manual_seed(0),
                           device=cuda)
        trainer = Trainer(model, make_optimizer(),
                          augment=SpecAugment(),
                          featurizer=featurizer("mfcc", cuda),
                          wav_augment=WavAugment(3.0, 20.0, 50.0))
        _, m = trainer.train_step(
            trainer.init_state(), *[torch.from_numpy(a).to(cuda)
                                    for a in batch],
            generator=torch.Generator(device=cuda).manual_seed(1),
            augment_generator=torch.Generator(device=cuda).manual_seed(2))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_device_extractor_pcm16_equals_dpack(cuda):
    from asr_study_torch.features.batch_extract import DeviceFeatureExtractor

    rng = np.random.RandomState(2)
    wavs = [(0.3 * np.sin(np.arange(n) * 0.05) + 0.02 * rng.randn(n))
            .astype(np.float32) for n in rng.randint(400, 60000, 37)]
    got = {}
    for codec in ("pcm16", "dpack"):
        before = (fbank.launches, dpack_decode.launches)
        ex = DeviceFeatureExtractor(batch=16, wire_codec=codec, device=cuda)
        got[codec] = ex.extract_batch(wavs)
        assert fbank.launches - before[0] == 3
        assert dpack_decode.launches - before[1] == (3 if codec == "dpack"
                                                     else 0)
    for a, b in zip(got["pcm16"], got["dpack"]):
        assert a.shape == b.shape and np.array_equal(a, b)
    plain = DeviceFeatureExtractor(batch=16, device="cpu").extract_batch(
        wavs)
    err = max(float(np.abs(a - b).max()) for a, b in zip(got["pcm16"],
                                                         plain))
    assert err <= 2e-3, err
    with pytest.raises(ValueError, match="mulaw is lossy"):
        DeviceFeatureExtractor(wire_codec="mulaw", device=cuda)


def test_augment_on_card_repeats_under_one_seed(cuda):
    from asr_study_torch.features.augment import SpecAugment, WavAugment

    x = torch.randn(6, 200, 39, device=cuda) + 3.0
    lens = torch.tensor([200, 150, 1, 0, 99, 7], device=cuda)
    w = torch.randn(6, 9000, device=cuda)
    wl = torch.tensor([9000, 4000, 1, 0, 8999, 100], device=cuda)
    w = torch.where(torch.arange(9000, device=cuda)[None] < wl[:, None],
                    w, 0.0)
    spec, wav = SpecAugment(3, 10, 3, 0.2), WavAugment(6.0, 0.0, 10.0)

    def run(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return spec(x, lens, g), wav(w, wl, g)

    a, b, c = run(4), run(4), run(5)
    for i in range(2):
        assert torch.equal(a[i], b[i]) and not torch.equal(a[i], c[i])
    pad = torch.arange(9000, device=cuda)[None] >= wl[:, None]
    assert bool((a[1][pad] == 0).all())
    masked = (a[0] == 0).any(dim=2)
    assert not bool(masked[:, 200:].any()) and bool(masked.any())


def test_h5_round_trip_on_card_machine(cuda, tmp_path):
    """Written and read by the port alone (the card's machine has no
    h5py), both layouts, through make_dataset-like writes and
    flow_from_h5."""
    from asr_study_torch.data import dataset_parser as dp
    from asr_study_torch.data.generator import DatasetGenerator
    from asr_study_torch.text.parser import CharParser

    class Arrays:
        def __call__(self, a):
            return a

        def __str__(self):
            return "arrays"

    rng = np.random.RandomState(0)
    utts = [{"audio": rng.randn(rng.randint(1, 300), 39).astype(np.float32),
             "label": "ola mundo", "duration": float(i % 7)}
            for i in range(300)]
    for layout in ("vlen", "packed"):
        path = str(tmp_path / f"{layout}.h5")
        dp.write_h5(path, {"train": utts}, Arrays(), CharParser(),
                    layout=layout)
        feats, labels, texts, durs = dp.read_h5(path, "train")
        order = (np.argsort([u["duration"] for u in utts], kind="stable")
                 if layout == "packed" else np.arange(len(utts)))
        for k, i in enumerate(order):
            assert np.array_equal(feats[k], utts[i]["audio"])
        assert texts == ["ola mundo"] * 300
        for lazy in (False, True):
            it = DatasetGenerator(batch_size=32).flow_from_h5(path, "train",
                                                              lazy=lazy)
            assert sum(b.weights.sum() for b in it.epoch(seed=0)) == 300


# -- streaming: carried state in the forward kernels, the beam's stream form -

# each forward route with a carry: the LSTM's and the GRU's cluster
# design at H=256 (and the LSTM's at H=100, ragged over the cluster), wide
# design at H=512, stream design by a batch past the wide design's budget;
# the layer-norm, MI and zoneout LSTMs' cluster design at H=256 and stream
# design at H=512
CARRY_ROUTES = [("lstm", 256, 5, "cluster"), ("lstm", 100, 3, "cluster"),
                ("lstm", 512, 5, "wide"), ("lstm", 512, 97, "stream"),
                ("gru", 256, 5, "cluster"), ("gru", 512, 5, "wide"),
                ("gru", 512, 97, "stream"),
                *[(kind, h, 5, "cluster" if h == 256 else "stream")
                  for kind in ("ln_lstm", "mi_lstm", "zoneout_lstm")
                  for h in (256, 512)]]
CARRY_TOL = dict(rtol=1e-5, atol=1e-4)   # chip_smoke.py's forward bounds
CARRY_OPS = {"lstm": (lstm, lstm_plain, lstm_geometry),
             "gru": (gru, gru_plain, gru_geometry),
             "ln_lstm": (ln_lstm, ln_lstm_plain, ln_geometry),
             "mi_lstm": (mi_lstm, mi_lstm_plain, mi_geometry),
             "zoneout_lstm": (zoneout_lstm, zoneout_lstm_plain,
                              zoneout_geometry)}


def _carry_case(cuda, family, t, b, h, seed):
    """xp, mask (the last row masked on every frame), the op's arguments
    after the mask (wh; the layer-norm LSTM's wh, gh, gc, bc; the MI
    LSTM's wh, alpha, beta1, beta2, b; the zoneout LSTM's eval-mode mix
    weights zh, zc, then wh) and a non-zero carry [(h0, c0) or (h0,)], on
    the card."""
    g = torch.Generator().manual_seed(seed)

    def near(n, centre):
        return centre + 0.1 * torch.randn(n, generator=g)

    gates = 3 if family == "gru" else 4
    xp = torch.randn(t, b, gates * h, generator=g)
    wh = torch.randn(h, gates * h, generator=g) / h ** 0.5
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0], lengths[-1] = t, 0
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    init = [0.5 * torch.randn(b, h, generator=g)
            for _ in range(1 if family == "gru" else 2)]
    rest = {"ln_lstm": lambda: [wh, near(4 * h, 1.0), near(h, 1.0),
                                near(h, 0.0)],
            "mi_lstm": lambda: [wh, near(4 * h, 1.0), near(4 * h, 1.0),
                                near(4 * h, 1.0), near(4 * h, 0.0)],
            "zoneout_lstm": lambda: [torch.full((t, b, h), 0.9),
                                     torch.full((t, b, h), 0.85), wh]
            }.get(family, lambda: [wh])()
    return (xp.to(cuda), mask.to(cuda), [a.to(cuda) for a in rest],
            [i.to(cuda) for i in init])


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("family,h,b,design", CARRY_ROUTES,
                         ids=[f"{f}-{h}-{b}-{d}"
                              for f, h, b, d in CARRY_ROUTES])
def test_carried_state_routes(cuda, family, h, b, design):
    """Each forward route started from a non-zero carry: against its plain
    twin at the forward tolerance; run in chunks of 16 frames (a ragged
    last one) threading h[-1] (and c[-1]) equal to one launch over the
    sequence bit for bit; no carry equal to an explicit zero carry bit for
    bit; the masked row holding its carry on every frame; every launch
    counted under the route; a wrong-shaped carry refused before any
    launch."""
    t = 45
    xp, mask, rest, init = _carry_case(cuda, family, t, b, h, seed=h + b)
    fn, plain, geometry = CARRY_OPS[family]
    assert geometry(h, b, 1).design == design

    def run(lo, hi, *carry):
        args = [a[lo:hi].contiguous() if a.dim() == 3 else a for a in rest]
        return _as_tuple(fn(xp[lo:hi].contiguous(), mask[lo:hi].contiguous(),
                            *args, *carry))

    before = dict(fn.by_design)
    whole = run(0, t, *init)
    chunks, carry = [], init
    for lo in range(0, t, 16):
        out = run(lo, lo + 16, *carry)
        chunks.append(out)
        carry = [o[-1] for o in out]
    null = run(0, t)
    zeros = run(0, t, *[torch.zeros_like(i) for i in init])
    with pytest.raises(ValueError, match="float32"):
        run(0, t, *[i[:2] for i in init])
    assert fn.by_design == {**before, design: before[design] + 6}
    want = _as_tuple(plain(xp, mask, *rest, *init))
    torch.cuda.synchronize()
    for got_, want_ in zip(whole, want):
        torch.testing.assert_close(got_, want_, **CARRY_TOL)
    for k, seq in enumerate(whole):
        assert torch.equal(torch.cat([c[k] for c in chunks]), seq)
    for a, z in zip(null, zeros):
        assert torch.equal(a, z)
    for seq, i in zip(whole, init):
        assert torch.equal(seq[:, -1], i[-1].expand(t, h))


BEAM_STREAM_CASES = [(4, 0, False, 7, 28), (16, 0, False, 64, 28),
                     (64, 0, False, 160, 28), (128, 0, False, 40, 28),
                     (16, 8, False, 33, 28), (16, 0, True, 50, 28),
                     (256, 0, True, 50, 28), (129, 8, False, 33, 65),
                     (160, 0, False, 7, 70)]


@pytest.mark.parametrize(
    "width,prune,with_lm,chunk,vocab", BEAM_STREAM_CASES,
    ids=[f"w{w}-p{p}-{'lm' if m else 'nolm'}-c{c}"
         + ("" if v == 28 else f"-v{v}")
         for w, p, m, c, v in BEAM_STREAM_CASES])
def test_beam_stream_kernel_matches_plain(cuda, width, prune, with_lm,
                                          chunk, vocab):
    """The beam kernels' stream form (the select design, and the wide one
    for W > 128 or V > 64) against beam_stream_plain chunk by chunk (rows
    of lengths T, ragged, 1 and 0): state, prefixes, emits, start slots
    and scores bit for bit, one launch a chunk; each row's best prefix
    spliced over the chunks equal to ctc_beam's one-shot best path."""
    logits, lens = _beam_emissions(cuda, vocab=vocab)
    lp = torch.log_softmax(logits, -1)
    b, t, _ = lp.shape
    lm = _beam_lm(0, vocab - 1) if with_lm else None
    kw = dict(prune=prune, lm=lm, lm_alpha=0.8, lm_beta=0.1)
    init = beam.beam_stream_init(width, lm.init_state() if lm else 0, cuda)
    state = beam.BeamState(*(s[None].repeat(b, 1) for s in init))
    spliced = [[[] for _ in range(width)] for _ in range(b)]
    design = beam.beam_design(width, vocab)
    for lo in range(0, t, chunk):
        n = (lens - lo).clamp(0, chunk)
        before = dict(beam.ctc_beam.by_design)
        got = beam.ctc_beam_stream(lp[:, lo: lo + chunk], n, state, width,
                                   **kw)
        assert beam.ctc_beam.by_design == {**before,
                                           design: before[design] + 1}
        want = beam.beam_stream_plain(lp[:, lo: lo + chunk], n, state, width,
                                      **kw)
        for g_, w_ in zip(got[0], want[0]):
            assert torch.equal(g_, w_)
        for g_, w_ in zip(got[1:], want[1:]):
            assert torch.equal(g_, w_)
        state = got[0]
        pref, emits, start = (x.cpu() for x in got[1:4])
        spliced = [[spliced[r][int(start[r, w])]
                    + pref[r, w, : int(emits[r, w])].tolist()
                    for w in range(width)] for r in range(b)]
    one = beam.ctc_beam(lp, lens, width, **kw)
    best = beam._sort_desc(got[4])[:, 0].cpu()
    for r in range(b):
        assert spliced[r][int(best[r])] == \
            one[0][r, 0, : int(one[1][r, 0])].tolist()


@pytest.mark.parametrize("name,hp,fwd", [
    ("deep_gru", "num_hiddens=64,num_layers=2,bidirectional=false", gru),
    ("deep_blstm", "num_hiddens=64,num_layers=2,bidirectional=false", lstm),
    ("deep_speech", "num_hiddens=512,input_dense=64,bidirectional=false",
     lstm)], ids=["deep_gru", "deep_blstm", "deep_speech_512"])
@pytest.mark.parametrize("width", [0, 8], ids=["greedy", "beam8"])
def test_streaming_recognizer_on_card(cuda, name, hp, fwd, width):
    """StreamingRecognizer on the card: one forward launch a layer and
    chunk (one beam launch a chunk with a beam), and the transcript equal
    to the whole utterance's decode on the card."""
    from asr_study_torch.features.audio import MFCC
    from asr_study_torch.ops.beam import BeamConfig, decode
    from asr_study_torch.streaming import StreamingRecognizer

    model = build_model(name, hp, num_classes=27, input_dim=39,
                        generator=torch.Generator().manual_seed(3),
                        device=cuda).eval()
    w, _ = _wavs(4, [37000], 37000)
    wav = w[0].numpy()
    feature = MFCC()
    rec = StreamingRecognizer(model, feature, chunk_frames=64,
                              beam_width=width)
    before = (fwd.launches, beam.ctc_beam.launches)
    for lo in range(0, len(wav), 5000):
        rec.push(wav[lo: lo + 5000])
    ids = rec.finish()
    feats = torch.from_numpy(feature(wav).astype(np.float32))[None].to(cuda)
    n_chunks = -(-feats.shape[1] // 64)
    assert (fwd.launches - before[0], beam.ctc_beam.launches - before[1]) \
        == (len(model.rnn.layers) * n_chunks, n_chunks if width else 0)
    lengths = torch.tensor([feats.shape[1]], device=cuda)
    with torch.inference_mode():
        logits = model(feats, lengths)
        dec, n = decode(logits, lengths, model.blank_id,
                        BeamConfig(width) if width else None)
    assert ids == dec[0, : int(n[0])].tolist()


# -- data parallelism (train / eval --num_devices) -----------------------------

DP_CASE = dict(model="deep_blstm", hp="num_hiddens=64,num_layers=2,"
               "dropout=0.0", spec=("sgd", 0.1, 400.0), flat=None,
               device="cuda:0")


def _dp_cases():
    """A full batch, the same again, and one of 5 real rows of 8 (the
    second rank holds one)."""
    return {"full": dict(DP_CASE, batches=[(1, None)]),
            "again": dict(DP_CASE, batches=[(1, None)]),
            "ragged": dict(DP_CASE, batches=[(1, dp_ranks.RAGGED)])}


def test_dp_two_ranks_on_one_card_match_one_process(cuda):
    """Two ranks on cuda:0 over gloo (host-staged: the card has no second
    device for NCCL) against the one-process step from the same weights,
    on the cluster LSTM and CTC kernels: loss rel 1e-5, each gradient
    within 1e-4 of its max abs, the ragged case too; two identical DP
    steps and the two ranks' weights bit-equal (chip_smoke.py's dp phase
    (a) at a small size)."""
    cases = _dp_cases()
    ranks = dp.launch(dp_ranks.rank_main, ["cuda:0", "cuda:0"],
                      args=(cases,), backend="gloo", join_timeout=300)
    for name in ("full", "ragged"):
        single = dp_ranks.run_case(cases[name])
        for r in ranks:
            assert r[name]["losses"][0] == pytest.approx(
                single["losses"][0], rel=1e-5), name
            for k, g in single["grads"].items():
                err = float(np.abs(r[name]["grads"][k] - g).max())
                assert err <= 1e-4 * float(np.abs(g).max()), (name, k, err)
    for r in ranks:
        assert r["full"]["losses"] == r["again"]["losses"]
        for k, g in r["full"]["grads"].items():
            np.testing.assert_array_equal(r["again"]["grads"][k], g)
    for k, v in ranks[0]["full"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["full"]["params"][k], v)


def test_tp_two_ranks_on_one_card_match_one_process(cuda):
    """Two ranks on cuda:0 over gloo as one data rank of two model shards
    (``dp.launch(..., tp=2)``: the gate-dim-sharded scan of
    ``parallel/tp.py``) against the one-process step on the cluster LSTM
    and CTC kernels, from the same weights: loss rel 1e-5, each gradient
    within 1e-4 of its max abs, the two ranks' weights bit-equal
    (chip_smoke.py's tp phase at a small size)."""
    import tp_ranks

    case = dict(DP_CASE, kind="step", batches=[(1, None)])
    ranks = dp.launch(tp_ranks.rank_main, ["cuda:0", "cuda:0"],
                      args=({"step": case},), backend="gloo",
                      join_timeout=300, tp=2)
    single = dp_ranks.run_case(case)
    for r in ranks:
        assert r["step"]["losses"][0] == pytest.approx(single["losses"][0],
                                                       rel=1e-5)
        for k, g in single["grads"].items():
            err = float(np.abs(r["step"]["grads"][k] - g).max())
            assert err <= 1e-4 * float(np.abs(g).max()), (k, err)
    for k, v in ranks[0]["step"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["step"]["params"][k], v)


def test_dp_one_nccl_rank_is_bit_equal_to_no_group(cuda, tmp_path):
    """A group of one rank over NCCL (the flat all-reduce and the division
    after it) steps bit for bit as the trainer without a group."""
    case = _dp_cases()["ragged"]
    want = dp_ranks.run_case(case)
    group = dp.make_group(0, 1, cuda, str(tmp_path / "store"))
    try:
        assert group.backend == "nccl"
        got = dp_ranks.run_case(case, group)
    finally:
        torch.distributed.destroy_process_group()
    assert got["losses"] == want["losses"]
    for key in ("grads", "params"):
        for k, v in want[key].items():
            np.testing.assert_array_equal(got[key][k], v, err_msg=k)
