"""The CUDA kernels of asr_study_torch against their plain versions, on
the card.  Every test here needs an NVIDIA GPU and skips without one; the
machine with the card has no JAX, so this file imports none and is run
there without the repo's conftest::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from asr_study_torch import _build
from asr_study_torch.cli.predict import pack_batches, serve_batch
from asr_study_torch.data import wire
from asr_study_torch.features.device import DeviceFeaturizer, spectral_plain
from asr_study_torch.features.fbank import (KernelFeaturizer, chain_design,
                                            fbank, launch_dft)
from asr_study_torch.features.select import featurizer
from asr_study_torch.models.zoo import (build_model, deep_blstm, deep_gru,
                                        graves2006)
from asr_study_torch.ops import ctc
from asr_study_torch.ops.dpack import dpack_decode, dpack_decode_plain
from asr_study_torch.ops.bilstm import (BiLSTMFunction, LSTMFunction, bilstm,
                                        bilstm_bwd, bilstm_bwd_gates_plain,
                                        bilstm_bwd_plain, bilstm_plain,
                                        cluster_info, lstm, lstm_bwd,
                                        lstm_bwd_gates_plain, lstm_bwd_plain,
                                        lstm_geometry, lstm_plain)
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


def _two_identical_steps(cuda, name, hp, seed=3):
    """Two train steps of ``name`` from the same weights, fresh Adam state,
    batch and generator seed -> [(loss, {param: grad}, {param: updated})]
    for each, all on the host."""
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
        trainer = Trainer(model, make_optimizer("adam", 1e-3, 400.0))
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
