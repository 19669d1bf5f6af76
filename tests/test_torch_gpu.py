"""The CUDA kernels of asr_study_torch against their plain versions, on
the card.  Every test here needs an NVIDIA GPU and skips without one; the
machine with the card has no JAX, so this file imports none and is run
there without the repo's conftest::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from asr_study_torch.cli.predict import pack_batches, serve_batch
from asr_study_torch.data import wire
from asr_study_torch.features.device import DeviceFeaturizer, spectral_plain
from asr_study_torch.features.fbank import KernelFeaturizer, fbank
from asr_study_torch.features.select import featurizer
from asr_study_torch.models.zoo import (build_model, deep_blstm, deep_gru,
                                        graves2006)
from asr_study_torch.ops import ctc
from asr_study_torch.ops.dpack import dpack_decode, dpack_decode_plain
from asr_study_torch.ops.bilstm import (BiLSTMFunction, LSTMFunction, bilstm,
                                        bilstm_bwd, bilstm_bwd_plain,
                                        bilstm_plain, lstm, lstm_bwd,
                                        lstm_bwd_plain, lstm_plain)
from asr_study_torch.ops.gru import (BiGRUFunction, GRUFunction, bigru,
                                     bigru_bwd, bigru_bwd_plain, bigru_plain,
                                     gru, gru_bwd, gru_bwd_plain, gru_plain)
from asr_study_torch.ops.ln_lstm import (BiLNLSTMFunction, LNLSTMFunction,
                                         bi_ln_lstm, bi_ln_lstm_bwd,
                                         bi_ln_lstm_bwd_plain,
                                         bi_ln_lstm_plain, ln_lstm,
                                         ln_lstm_bwd, ln_lstm_bwd_plain,
                                         ln_lstm_plain)
from asr_study_torch.models.cells import ZoneoutLSTMCell
from asr_study_torch.ops.mi_lstm import (BiMILSTMFunction, MILSTMFunction,
                                         bi_mi_lstm, bi_mi_lstm_bwd,
                                         bi_mi_lstm_bwd_plain,
                                         bi_mi_lstm_plain, mi_lstm,
                                         mi_lstm_bwd, mi_lstm_bwd_plain,
                                         mi_lstm_plain)
from asr_study_torch.ops.zoneout_lstm import (BiZoneoutLSTMFunction,
                                              ZoneoutLSTMFunction,
                                              bi_zoneout_lstm,
                                              bi_zoneout_lstm_bwd,
                                              bi_zoneout_lstm_bwd_plain,
                                              bi_zoneout_lstm_plain,
                                              zoneout_lstm, zoneout_lstm_bwd,
                                              zoneout_lstm_bwd_plain,
                                              zoneout_lstm_plain)
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


@pytest.mark.parametrize("kind,kw", [
    ("mfcc", {}),
    ("mfcc", {"convention": "librosa"}),
    ("mfcc", {"append_energy": False}),
    ("logfbank", {"append_energy": True}),
    ("fbank", {}),
])
def test_fbank_kernel_matches_plain(cuda, kind, kw):
    w, lens = _wavs(0, [9000, 5000, 700, 12000, 3], 12000)
    feat = KernelFeaturizer(kind=kind, device=cuda, **kw)
    pre, t_out, _ = feat._prep(w.to(cuda), lens.to(cuda))
    before = fbank.launches
    got = fbank(feat.chain, pre, t_out)
    assert fbank.launches == before + 1
    want = spectral_plain(feat.chain, pre, t_out)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (5, t_out, feat.chain.num_out)
    if kind == "fbank":      # linear energies: relative error
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    else:                    # log domain (chip_smoke.py FBANK_TOL)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (37, 5, 100), (50, 9, 256),
                                   (3, 1, 300), (20, 3, 512)])
def test_bilstm_kernel_matches_plain(cuda, t, b, h):
    g = torch.Generator().manual_seed(h)
    xp_f = torch.randn(t, b, 4 * h, generator=g)
    xp_b = torch.randn(t, b, 4 * h, generator=g)
    wh_f = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    wh_b = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    args = [a.to(cuda) for a in (xp_f, xp_b, mask, wh_f, wh_b)]
    before = bilstm.launches
    got = bilstm(*args)
    assert bilstm.launches == before + 1
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
                                  "53247"])
def test_dpack_kernel_matches_plain(cuda, name):
    """The whole [scap] stream bit for bit, and the unpacked batch equal to
    the pcm16 wire's."""
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
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    n_pad = -(-max(len(w) for w in wavs) // 2048) * 2048
    pcm = wire.pack_audio(wavs, wire.wire_cap(b, sum(map(len, wavs))))
    w_d, l_d = wire.unpack_audio(flat, b, n_pad, codec="dpack", scap=scap)
    w_p, l_p = wire.unpack_audio(torch.from_numpy(pcm).to(cuda), b, n_pad)
    assert torch.equal(w_d, w_p) and torch.equal(l_d, l_p)


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


def _bilstm_case(cuda, t, b, h, seed):
    g = torch.Generator().manual_seed(seed)
    xp_f = torch.randn(t, b, 4 * h, generator=g)
    xp_b = torch.randn(t, b, 4 * h, generator=g)
    wh_f = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    wh_b = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = (torch.randn(t, b, h, generator=g), torch.randn(t, b, h, generator=g))
    return ([a.to(cuda) for a in (xp_f, xp_b, mask, wh_f, wh_b)],
            [a.to(cuda) for a in dh])


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (37, 5, 100), (50, 9, 256),
                                   (3, 1, 300), (512, 32, 256), (20, 3, 512)])
def test_bilstm_bwd_kernel_matches_plain(cuda, t, b, h):
    args, dh = _bilstm_case(cuda, t, b, h, seed=h + t)
    res = bilstm(*args)
    before = bilstm_bwd.launches
    got = bilstm_bwd(*args, *res, *dh)
    assert bilstm_bwd.launches == before + 1
    want = bilstm_bwd_plain(*args, *res, *dh)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("dxp_f", "dxp_b"), got, want):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256)])
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
    lab_lens[0] = l_max
    with torch.no_grad():
        return [x.to(cuda) for x in ctc.lattice(logits, lengths, labels,
                                                lab_lens)]


@pytest.mark.parametrize("b,t,l_max", [(4, 14, 4), (3, 40, 30),
                                       (32, 512, 48)])
def test_ctc_kernels_match_plain(cuda, b, t, l_max):
    """alpha and gamma: floor entries equal, the rest within CTC_TOL; and
    the posterior gradient built from them.  (3, 40, 30) has infeasible
    rows; label length 0 occurs."""
    lp_ext, valid, skip, end, ll = _lattice(cuda, b, t, l_max, seed=t)
    skip2 = ctc.skip_from_source(skip)
    end_ind = ctc.end_indicator(end, ll, lp_ext.shape[2])
    a0, b0 = ctc.ctc_alpha.launches, ctc.ctc_beta.launches
    alpha = ctc.ctc_alpha(lp_ext, valid, skip)
    gamma = ctc.ctc_beta(lp_ext, valid, alpha, skip2, end_ind)
    assert (ctc.ctc_alpha.launches, ctc.ctc_beta.launches) == (a0 + 1,
                                                               b0 + 1)
    alpha_p = ctc.ctc_alpha_plain(lp_ext, valid, skip)
    gamma_p = ctc.ctc_beta_plain(lp_ext, valid, alpha_p, skip2, end_ind)
    for got, want in ((alpha, alpha_p), (gamma, gamma_p)):
        floor = want <= -5e29
        assert torch.equal(got <= -5e29, floor)
        torch.testing.assert_close(got[~floor], want[~floor], **CTC_TOL)
    ones = torch.ones(b, device=cuda)
    dlp = ctc.posterior_grad(gamma, ctc.final_logp(alpha[-1], end, ll), ones)
    dlp_p = ctc.posterior_grad(gamma_p, ctc.final_logp(alpha_p[-1], end, ll),
                               ones)
    torch.testing.assert_close(dlp, dlp_p, rtol=0, atol=1e-5)


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


def _gru_case(cuda, t, b, h, seed):
    """xp_f, xp_b [T,B,3H], ragged mask, wh_f, wh_b [H,3H] and two
    cotangents [T,B,H], on the card."""
    g = torch.Generator().manual_seed(seed)
    xp = [torch.randn(t, b, 3 * h, generator=g) for _ in range(2)]
    wh = [torch.randn(h, 3 * h, generator=g) / h ** 0.5 for _ in range(2)]
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = [torch.randn(t, b, h, generator=g) for _ in range(2)]
    return ([a.to(cuda) for a in (xp[0], xp[1], mask, wh[0], wh[1])],
            [a.to(cuda) for a in dh])


@pytest.mark.parametrize("t,b,h", GRU_SIZES)
def test_gru_fwd_kernels_match_plain(cuda, t, b, h):
    """bigru (two directions) and gru (one) against their plain loops."""
    args, _ = _gru_case(cuda, t, b, h, seed=h + t)
    before = (bigru.launches, gru.launches)
    got = bigru(*args)
    got_uni = gru(args[0], args[2], args[3])
    assert (bigru.launches, gru.launches) == (before[0] + 1, before[1] + 1)
    want = bigru_plain(*args)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("h_f", "h_b"), got, want):
        torch.testing.assert_close(g_, w_, **GRU_TOL, msg=name)
    torch.testing.assert_close(got_uni, want[0], **GRU_TOL)


@pytest.mark.parametrize("t,b,h", GRU_SIZES)
def test_gru_bwd_kernels_match_plain(cuda, t, b, h):
    """bigru_bwd and gru_bwd: dxp and dhp of each direction."""
    args, dh = _gru_case(cuda, t, b, h, seed=h + t + 1)
    hs = bigru(*args)
    before = (bigru_bwd.launches, gru_bwd.launches)
    got = bigru_bwd(*args, *hs, *dh)
    got_uni = gru_bwd(args[0], args[2], args[3], hs[0], dh[0])
    assert (bigru_bwd.launches, gru_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = bigru_bwd_plain(*args, *hs, *dh)
    want_uni = gru_bwd_plain(args[0], args[2], args[3], hs[0], dh[0])
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("dxp_f", "dhp_f", "dxp_b", "dhp_b"), got, want):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)
    for name, g_, w_ in zip(("dxp", "dhp"), got_uni, want_uni):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


def _grads(fn, leaves, dh):
    leaves = [a.clone().requires_grad_() for a in leaves]
    outs = fn(*leaves)
    torch.autograd.backward(outs, dh[:len(outs)])
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256)])
def test_gru_functions_match_autograd_on_card(cuda, t, b, h):
    """Gradients of xp and wh through BiGRUFunction and GRUFunction (both
    kernels each) against autograd through the plain loops, on the card."""
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


@pytest.mark.parametrize("t,b,h", LSTM_SIZES)
def test_lstm_kernels_match_plain(cuda, t, b, h):
    """lstm (one direction of bilstm_fwd) and lstm_bwd (of bilstm_bwd)
    against their plain loops: h, c and dxp; H=100 has a gate width not a
    multiple of 32, H=512 takes more than 48 KB of shared memory."""
    args, dh = _bilstm_case(cuda, t, b, h, seed=h + t + 2)
    xp, mask, wh = args[0], args[2], args[3]
    before = (lstm.launches, lstm_bwd.launches, bilstm.launches)
    h_k, c_k = lstm(xp, mask, wh)
    dxp = lstm_bwd(xp, mask, wh, h_k, c_k, dh[0])
    assert (lstm.launches, lstm_bwd.launches, bilstm.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    h_p, c_p = lstm_plain(xp, mask, wh)
    dxp_p = lstm_bwd_plain(xp, mask, wh, h_k, c_k, dh[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(h_k, h_p, rtol=0, atol=1e-4, msg="h")
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-4, msg="c")
    torch.testing.assert_close(dxp, dxp_p, **BWD_TOL, msg="dxp")


@pytest.mark.parametrize("t,b,h", [(12, 4, 8), (40, 6, 256)])
def test_lstm_function_matches_autograd_on_card(cuda, t, b, h):
    """Gradients of xp and wh through LSTMFunction (both kernels) against
    autograd through the plain loop, on the card."""
    (xp, _, mask, wh, _), dh = _bilstm_case(cuda, t, b, h, seed=11)
    got = _grads(lambda x, w: (LSTMFunction.apply(x, mask, w),), (xp, wh),
                 dh)
    want = _grads(lambda x, w: (lstm_plain(x, mask, w)[0],), (xp, wh), dh)
    for name, g_, w_ in zip(("dxp", "dwh"), got, want):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


# plain-LSTM models beside deep_blstm: name, hparams, forward and backward
# wrapper, recurrent layers
LSTM_ZOO = [
    ("deep_blstm", "num_hiddens=24,num_layers=2,bidirectional=false",
     lstm, lstm_bwd, 2),
    ("highway_blstm", "num_hiddens=24,num_layers=2", bilstm, bilstm_bwd, 2),
    ("residual_blstm", "num_hiddens=24,num_layers=2,bidirectional=false",
     lstm, lstm_bwd, 2),
    ("deep_speech", "num_hiddens=24,input_dense=32", bilstm, bilstm_bwd, 1),
]
LSTM_ZOO_IDS = ["deep_blstm_uni", "highway", "residual_uni", "deep_speech"]


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


def _ln_case(cuda, t, b, h, seed):
    """Both directions' LN-LSTM arguments (xpn, wh, gh, gc, bc; gains about
    1 and biases about 0, none exactly), a ragged mask and two cotangents,
    on the card -> (xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b,
    bc_f, bc_b), [dh_f, dh_b]."""
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
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = [torch.randn(t, b, h, generator=g) for _ in range(2)]
    args = (xpn[0], xpn[1], mask, wh[0], wh[1], gh[0], gh[1], gc[0], gc[1],
            bc[0], bc[1])
    return [a.to(cuda) for a in args], [a.to(cuda) for a in dh]


LN_SIZES = [(12, 4, 8), (37, 5, 100), (50, 9, 256), (3, 1, 300)]


@pytest.mark.parametrize("t,b,h", LN_SIZES)
def test_ln_fwd_kernels_match_plain(cuda, t, b, h):
    """bi_ln_lstm (two directions of ln_lstm_fwd) and ln_lstm (one) against
    their plain loops: h and raw c (chip_smoke.py's BILSTM_* bounds)."""
    args, _ = _ln_case(cuda, t, b, h, seed=h + t)
    xf, _, mask, whf, _, ghf, _, gcf, _, bcf, _ = args
    before = (bi_ln_lstm.launches, ln_lstm.launches)
    got = bi_ln_lstm(*args)
    got_uni = ln_lstm(xf, mask, whf, ghf, gcf, bcf)
    assert (bi_ln_lstm.launches, ln_lstm.launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = bi_ln_lstm_plain(*args)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("h_f", "c_f", "h_b", "c_b", "h", "c"),
                            (*got, *got_uni), (*want, *want[:2])):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4, msg=name)


@pytest.mark.parametrize("t,b,h", LN_SIZES)
def test_ln_bwd_kernels_match_plain(cuda, t, b, h):
    """bi_ln_lstm_bwd and ln_lstm_bwd: dpre and dcn of each direction."""
    args, dh = _ln_case(cuda, t, b, h, seed=h + t + 1)
    xf, _, mask, whf, _, ghf, _, gcf, _, bcf, _ = args
    hc = bi_ln_lstm(*args)
    before = (bi_ln_lstm_bwd.launches, ln_lstm_bwd.launches)
    got = bi_ln_lstm_bwd(*args, *hc, *dh)
    uni = (xf, mask, whf, ghf, gcf, bcf, hc[0], hc[1], dh[0])
    got_uni = ln_lstm_bwd(*uni)
    assert (bi_ln_lstm_bwd.launches, ln_lstm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = bi_ln_lstm_bwd_plain(*args, *hc, *dh)
    want_uni = ln_lstm_bwd_plain(*uni)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("dpre_f", "dcn_f", "dpre_b", "dcn_b", "dpre",
                             "dcn"), (*got, *got_uni), (*want, *want_uni)):
        torch.testing.assert_close(g_, w_, **BWD_TOL, msg=name)


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


ZO_SIZES = [(12, 4, 8), (37, 5, 100), (50, 9, 256), (3, 1, 300)]


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


@pytest.mark.parametrize("mix", ["bernoulli", "constant"])
@pytest.mark.parametrize("t,b,h", ZO_SIZES)
def test_zoneout_kernels_match_plain(cuda, t, b, h, mix):
    """bi_zoneout_lstm and zoneout_lstm (the zoneout_lstm_fwd kernel with
    two and one directions) and their backwards against the plain loops:
    mixed h and c (chip_smoke.py's BILSTM_* bounds), dxp (BWD_TOL)."""
    args, dh = _zoneout_case(cuda, t, b, h, t + h, mix)
    uni = _zo_uni(args)
    before = [f.launches for f in (bi_zoneout_lstm, zoneout_lstm,
                                   bi_zoneout_lstm_bwd, zoneout_lstm_bwd)]
    got = bi_zoneout_lstm(*args)
    got_uni = zoneout_lstm(*uni)
    d = bi_zoneout_lstm_bwd(*args, *got, *dh)
    d_uni = zoneout_lstm_bwd(*uni, *got_uni, dh[0])
    assert [f.launches - n for f, n in zip(
        (bi_zoneout_lstm, zoneout_lstm, bi_zoneout_lstm_bwd,
         zoneout_lstm_bwd), before)] == [1, 1, 1, 1]
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


def test_zoneout_rate_zero_kernel_is_the_lstm_kernel(cuda):
    """zh = zc = 1: zoneout_lstm_fwd gives what bilstm_fwd gives."""
    args, _ = _zoneout_case(cuda, 40, 6, 256, 3, "constant")
    ones = torch.ones_like(args[3])
    got = bi_zoneout_lstm(*args[:3], ones, ones, ones, ones, *args[7:])
    want = bilstm(*args[:3], *args[7:])
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)


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


MI_SIZES = [(12, 4, 8), (37, 5, 100), (50, 9, 256), (3, 1, 300)]


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


@pytest.mark.parametrize("t,b,h", MI_SIZES)
def test_mi_kernels_match_plain(cuda, t, b, h):
    """bi_mi_lstm and mi_lstm (the mi_lstm_fwd kernel with two and one
    directions) and their backwards against the plain loops: h and c
    (chip_smoke.py's BILSTM_* bounds), dpre (BWD_TOL)."""
    args, dh = _mi_case(cuda, t, b, h, t + h)
    uni = _mi_uni(args)
    before = [f.launches for f in (bi_mi_lstm, mi_lstm, bi_mi_lstm_bwd,
                                   mi_lstm_bwd)]
    got = bi_mi_lstm(*args)
    got_uni = mi_lstm(*uni)
    d = bi_mi_lstm_bwd(*args, *got, *dh)
    d_uni = mi_lstm_bwd(*uni, *got_uni, dh[0])
    assert [f.launches - n for f, n in zip(
        (bi_mi_lstm, mi_lstm, bi_mi_lstm_bwd, mi_lstm_bwd),
        before)] == [1, 1, 1, 1]
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
