"""Time the port's host loops on this machine's CPU, in turns against
another checkout of the repository (for example its parent commit):

    python3 host_loops.py                    # this checkout, two turns
    python3 host_loops.py --against DIR      # DIR, this, this, DIR
    python3 host_loops.py --no_device --n 40 # no card: a quick dry run

One SynthWords corpus (``--n`` utterances, seed 0) is made once, with its
host-MFCC ``.h5`` files in both layouts.  Each turn is a process of its
own that imports ``asr_study_torch`` from its checkout and times:

- ``read_wav`` over the corpus's files, and ``read_wav_plain`` in turns
  with it where the checkout has one (ms a file), each file's samples
  freed at once, and kept for a chunk of 256 files as ``make_dataset``
  keeps them; beside them one ``os.stat`` a file, the price of a system
  call on this machine;
- ``make_dataset --device`` over the pcm16 and the dpack wires (the
  card's fbank and dpack decode kernels; one untimed pcm16 run first, so
  no kernel build or CUDA start-up is timed; utterances/s);
- ``flow_from_h5`` over one epoch of the train split, eager and lazy, vlen
  and packed (MB of features a second);
- ``wer`` and ``cer`` of the corpus's transcripts against seeded
  corruptions of them (deletions, substitutions and insertions, 8-12% of
  the characters each), and the same through ``_levenshtein_py`` where
  the checkout routes them elsewhere (ms over the corpus).

It prints a line a turn, then each number's mean by checkout, and the
card's name and power limit.  Host times vary with the machine's load,
so compare two checkouts only within one run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
LOG_FLOOR = 1e-2


def corpus_args(work: str, n: int) -> list:
    return ["--parser", "synthwords", "--dataset_dir",
            os.path.join(work, "corpus"), "--corpus_params",
            json.dumps({"n": n, "seed": SEED})]


def make_corpus(work: str, n: int) -> None:
    """The corpus, its manifest and its host-MFCC files, by this checkout."""
    import contextlib
    import io

    from asr_study_torch.cli import make_dataset

    for extra in (["--to_json", os.path.join(work, "m.json")],
                  ["--output", os.path.join(work, "vlen.h5")],
                  ["--output", os.path.join(work, "packed.h5"),
                   "--layout", "packed"]):
        with contextlib.redirect_stdout(io.StringIO()):
            assert make_dataset.main([*corpus_args(work, n), *extra]) == 0


def corrupt(text: str, rng) -> str:
    alpha = "abcdefghijklmnopqrstuvwxyz "
    out = []
    for ch in text:
        r = rng.random()
        if r < 0.12:
            continue
        out.append(alpha[rng.integers(len(alpha))] if r < 0.24 else ch)
        if rng.random() < 0.08:
            out.append(alpha[rng.integers(len(alpha))])
    return "".join(out)


def worker(repo: str, work: str, n: int, device: bool) -> dict:
    """One turn: the host loops of the checkout at ``repo``."""
    sys.path.insert(0, repo)
    import contextlib
    import io

    import numpy as np

    import asr_study_torch
    from asr_study_torch.cli import make_dataset
    from asr_study_torch.data.dataset_parser import H5FeatureRows
    from asr_study_torch.data.generator import DatasetGenerator
    from asr_study_torch.features import wav
    from asr_study_torch.ops import metrics

    assert os.path.dirname(os.path.dirname(
        os.path.abspath(asr_study_torch.__file__))) == os.path.abspath(repo)
    res = {}
    paths = sorted(os.path.join(work, "corpus", p)
                   for p in os.listdir(os.path.join(work, "corpus"))
                   if p.endswith(".wav"))

    # read_wav (and its plain twin, in turns)
    fns = {"read_wav": wav.read_wav}
    if hasattr(wav, "read_wav_plain"):
        fns["read_wav_plain"] = wav.read_wav_plain
    t0 = time.perf_counter()
    for p in paths:
        os.stat(p)
    res["os.stat ms a file"] = 1e3 * (time.perf_counter() - t0) / len(paths)
    for fn in fns.values():
        fn(paths[0], sr=None)  # a library's build or load is not timed
    secs = dict.fromkeys(fns, 0.0)
    for order in (list(fns), list(fns)[::-1]):
        for p in paths:
            for name in order:
                t0 = time.perf_counter()
                fns[name](p, sr=None)
                secs[name] += time.perf_counter() - t0
    for name, s in secs.items():
        res[f"{name} ms a file"] = 1e3 * s / (2 * len(paths))
    # as make_dataset reads: a chunk of 256 files' samples kept at once
    secs = dict.fromkeys(fns, 0.0)
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            for c in range(0, len(paths), 256):
                t0 = time.perf_counter()
                kept = [fns[name](p, sr=16000)[0] for p in paths[c: c + 256]]
                secs[name] += time.perf_counter() - t0
                del kept
    for name, s in secs.items():
        res[f"{name} ms a file, 256 kept"] = 1e3 * s / (2 * len(paths))

    # make_dataset --device, both wires
    if device:
        import torch

        def run(codec: str) -> float:
            out = os.path.join(work, f"dev_{os.getpid()}_{codec}.h5")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                assert make_dataset.main([
                    *corpus_args(work, n), "--output", out, "--device",
                    "--device_wire_codec", codec, "--input_params",
                    json.dumps({"log_floor": LOG_FLOOR})]) == 0
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            os.remove(out)
            return dt

        run("pcm16")
        for codec in ("pcm16", "dpack"):
            res[f"make_dataset --device {codec} utterances/s"] = \
                n / run(codec)

    # flow_from_h5, one epoch of the train split
    for layout in ("vlen", "packed"):
        path = os.path.join(work, f"{layout}.h5")
        mb = H5FeatureRows(path, "train").nbytes / 2**20
        for lazy in (False, True):
            t0 = time.perf_counter()
            it = DatasetGenerator(batch_size=32).flow_from_h5(
                path, "train", lazy=lazy)
            sum(1 for _ in it.epoch(seed=SEED))
            res[f"flow_from_h5 {layout} {'lazy' if lazy else 'eager'} "
                f"MB/s"] = mb / (time.perf_counter() - t0)

    # wer / cer over the corpus's transcripts
    with open(os.path.join(work, "m.json")) as f:
        refs = [json.loads(line)["label"] for line in f if line.strip()]
    rng = np.random.default_rng(SEED)
    hyps = [corrupt(r, rng) for r in refs]
    metrics.wer(hyps[:1], refs[:1])
    routes = {"": None}
    if hasattr(metrics, "levenshtein"):
        routes[" (_levenshtein_py)"] = metrics._levenshtein_py
    for suffix, lev in list(routes.items()) * 2:
        saved = getattr(metrics, "levenshtein", None)
        if lev is not None:
            metrics.levenshtein = lev
        try:
            for name in ("wer", "cer"):
                t0 = time.perf_counter()
                val = getattr(metrics, name)(hyps, refs)
                key = f"{name} ms over {len(refs)} pairs{suffix}"
                res[key] = res.get(key, 0.0) + 500 * (time.perf_counter()
                                                      - t0)
                res[f"{name} value"] = val
        finally:
            if lev is not None:
                metrics.levenshtein = saved
    return res


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except OSError:
        return "no card (nvidia-smi absent)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout, timed in turns")
    ap.add_argument("--n", type=int, default=800, help="corpus utterances")
    ap.add_argument("--no_device", action="store_true",
                    help="leave make_dataset --device out (no card)")
    ap.add_argument("--worker", nargs=2, metavar=("REPO", "WORK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(*args.worker, args.n, not args.no_device)))
        return 0
    sys.path.insert(0, HERE)
    work = tempfile.mkdtemp(prefix="host_loops_")
    try:
        t0 = time.perf_counter()
        make_corpus(work, args.n)
        print(f"corpus of {args.n} and its host-MFCC files made in "
              f"{time.perf_counter() - t0:.1f} s")
        turns = ([args.against, HERE, HERE, args.against] if args.against
                 else [HERE, HERE])
        by_repo: dict = {}
        for repo in turns:
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   os.path.abspath(repo), work, "--n", str(args.n)]
            if args.no_device:
                cmd.append("--no_device")
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  cwd=os.path.abspath(repo))
            if proc.returncode:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"turn {os.path.abspath(repo)}: {json.dumps(res)}")
            by_repo.setdefault(os.path.abspath(repo), []).append(res)
        print("means by checkout (host time on this machine's CPU):")
        for repo, runs in by_repo.items():
            keys = sorted({k for r in runs for k in r})
            means = {k: sum(r[k] for r in runs if k in r)
                     / sum(k in r for r in runs) for k in keys}
            print(f"  {repo}: " + "; ".join(f"{k} {v:.4f}"
                                            for k, v in means.items()))
        print(f"card: {card_line()}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
