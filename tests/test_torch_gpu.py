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
from asr_study_torch.features.device import DeviceFeaturizer, spectral_plain
from asr_study_torch.features.fbank import KernelFeaturizer, fbank
from asr_study_torch.features.select import featurizer
from asr_study_torch.models.zoo import (build_model, deep_blstm, deep_gru,
                                        graves2006)
from asr_study_torch.ops import ctc
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
    chunk, cap, n_pad = pack_batches(wavs, 3)
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
    chunk, cap, n_pad = pack_batches(wavs, 3)
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
    chunk, cap, n_pad = pack_batches(wavs, 3)
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
    chunk, cap, n_pad = pack_batches(wavs, 3)
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
