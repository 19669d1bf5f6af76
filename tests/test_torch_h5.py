"""The port's HDF5 reader and writer (``asr_study_torch/data/h5.py``) and
its dataset functions, held against h5py and the JAX package on the CPU.

Exact, both ways: files that the JAX ``write_h5`` writes through h5py
(both layouts, an ``inputs_flat`` of more than one chunk, non-ASCII texts,
an empty label row) read by the port as the JAX ``read_h5`` reads them;
files the port writes read by h5py and the JAX ``read_h5`` (past 65,535
heap objects too).  Files outside the subset (gzip, ``libver="latest"``,
big-endian) are refused with a message.  ``flow_from_h5`` batches, eager
and lazy, equal the JAX generator's for the same seed."""

import h5py
import numpy as np
import pytest

from asr_study_torch.data import h5
from asr_study_torch.data import dataset_parser as pdp
from asr_study_torch.data.generator import DatasetGenerator
from asr_study_torch.text.parser import CharParser as PortParser
from asr_study_tpu.data import dataset_parser as jdp
from asr_study_tpu.data.generator import DatasetGenerator as JaxGenerator
from asr_study_tpu.text.parser import CharParser as JaxParser

VOCAB = "abcdeãçé "
TEXTS = ["cão", "", "abc de", "é", "ação cab", "da", "e e e", "b"]


class ArrayFeature:
    """A feature "extractor" whose audio is the feature matrix itself."""

    def __call__(self, audio):
        return audio

    def __str__(self):
        return "arrays"


def _utts(n, seed, f_dim=3, t_max=40):
    rng = np.random.RandomState(seed)
    return [{"audio": rng.randn(rng.randint(1, t_max), f_dim)
             .astype(np.float32),
             "label": TEXTS[i % len(TEXTS)],
             "duration": float(rng.uniform(0.5, 3.0))} for i in range(n)]


def _assert_split_equal(got, want):
    g_in, g_lab, g_txt, g_dur = got
    w_in, w_lab, w_txt, w_dur = want
    assert len(g_in) == len(w_in)
    for a, b in zip(g_in, w_in):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert len(g_lab) == len(w_lab)
    for a, b in zip(g_lab, w_lab):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert g_txt == w_txt
    np.testing.assert_array_equal(g_dur, w_dur)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Both layouts as the JAX writer makes them: a train split of 600
    one-column rows (> 2 x 8192 frames, so inputs_flat spans several chunks)
    and a small valid split with non-ASCII texts and an empty label."""
    d = tmp_path_factory.mktemp("jaxh5")
    rows = {"train": _utts(600, 0, f_dim=1, t_max=60),
            "valid": _utts(9, 1)}
    paths = {}
    for layout in ("vlen", "packed"):
        paths[layout] = str(d / f"{layout}.h5")
        jdp.write_h5(paths[layout], rows, ArrayFeature(),
                     JaxParser(VOCAB, normalize=False), layout=layout)
    with h5py.File(paths["packed"], "r") as f:
        flat = f["train"]["inputs_flat"]
        assert flat.chunks == (8192, 1) and flat.shape[0] > 2 * 8192
    return paths


@pytest.mark.parametrize("layout", ["vlen", "packed"])
@pytest.mark.parametrize("split", ["train", "valid"])
def test_reads_jax_files_exactly(jax_files, layout, split):
    path = jax_files[layout]
    want = jdp.read_h5(path, split)
    _assert_split_equal(pdp.read_h5(path, split), want)
    if split == "valid":
        assert "cão" in want[2] and "" in want[2]
        assert any(len(l) == 0 for l in want[1])
    shapes, labels, texts, durs = pdp.read_h5_meta(path, split)
    np.testing.assert_array_equal(shapes, jdp.read_h5_meta(path, split)[0])
    for a, b in zip(pdp.read_h5_inputs(path, split, shapes), want[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["vlen", "packed"])
def test_attributes_and_feature_rows(jax_files, layout):
    path = jax_files[layout]
    with h5.File(path) as f, h5py.File(path, "r") as g:
        assert f.keys() == list(g)
        for split in f:
            a, b = f[split].attrs, g[split].attrs
            assert set(a) == set(b)
            for k in b:
                assert a[k] == b[k] and type(a[k]) is type(b[k])
            assert f[split].keys() == list(g[split])
    rows = pdp.H5FeatureRows(path, "train")
    ref = jdp.H5FeatureRows(path, "train")
    assert len(rows) == len(ref) and rows.nbytes == ref.nbytes
    assert rows.num_feats == ref.num_feats == 1
    for i in (0, 5, 599):
        np.testing.assert_array_equal(rows[i], ref[i])
    # several runs; one run out of order (packed from its one read); none
    for idx in ([7, 3, 4, 5, 300, 2], [12, 10, 11, 13], []):
        idx = np.array(idx, np.int64)
        got = np.full((8, 64, 1), np.nan, np.float32)
        want = np.full((8, 64, 1), np.nan, np.float32)
        rows.pack_into(idx, got)
        ref.pack_into(idx, want)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["vlen", "packed"])
def test_jax_and_h5py_read_port_files_exactly(tmp_path, layout):
    rows = {"train": _utts(40, 2), "test": _utts(8, 3)}
    port, jax = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    pdp.write_h5(port, rows, ArrayFeature(),
                 PortParser(VOCAB, normalize=False), layout=layout)
    jdp.write_h5(jax, rows, ArrayFeature(),
                 JaxParser(VOCAB, normalize=False), layout=layout)
    for split in ("train", "test"):
        _assert_split_equal(jdp.read_h5(port, split), jdp.read_h5(jax, split))
        _assert_split_equal(pdp.read_h5(port, split), jdp.read_h5(jax, split))
    with h5py.File(port, "r") as a, h5py.File(jax, "r") as b:
        assert list(a) == list(b) == ["test", "train"]
        for split in a:
            assert list(a[split]) == list(b[split])
            assert dict(a[split].attrs) == dict(b[split].attrs)
            for name in a[split]:
                assert a[split][name].dtype == b[split][name].dtype
                assert a[split][name].shape == b[split][name].shape
    with pytest.raises(KeyError, match="no split 'valid'"):
        pdp.read_h5(port, "valid")


def test_past_one_heap_collection(tmp_path):
    """65,540 variable-length rows: the writer starts a second collection
    before the 16-bit object index runs out; h5py reads every row."""
    n = h5.HEAP_MAX_OBJECTS + 5
    path = str(tmp_path / "many.h5")
    want = [np.arange(i % 3, dtype=np.int32) + i for i in range(n)]
    with h5.Writer(path) as w:
        col = w.group("g").vlen_dataset("rows", np.int32)
        for r in want:
            col.append(r)
    with h5py.File(path, "r") as f:
        got = f["g"]["rows"][:]
    assert len(got) == n
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with h5.File(path) as f:
        ds = f["g"]["rows"]
        assert all(np.array_equal(ds[i], want[i])
                   for i in (0, 65534, 65535, n - 1))
        assert len(f._heaps) >= 2


@pytest.mark.parametrize("kind", ["gzip", "shuffle", "latest", "bigendian",
                                  "track_order", "compact", "not_hdf5"])
def test_refuses_outside_the_subset(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    data = np.arange(100, dtype=np.float32).reshape(50, 2)
    if kind == "not_hdf5":
        with open(path, "wb") as f:
            f.write(b"\0" * 200)
    else:
        with h5py.File(path, "w", libver="latest" if kind == "latest"
                       else "earliest",
                       track_order=kind == "track_order") as f:
            g = f.create_group("train")
            if kind == "gzip":
                g.create_dataset("x", data=data, compression="gzip",
                                 chunks=(10, 2))
            elif kind == "shuffle":
                g.create_dataset("x", data=data, shuffle=True, chunks=(10, 2))
            elif kind == "bigendian":
                g.create_dataset("x", data=data.astype(">f4"))
            elif kind == "compact":
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_layout(h5py.h5d.COMPACT)
                h5py.h5d.create(g.id, b"x", h5py.h5t.STD_I16LE,
                                h5py.h5s.create_simple((3,)), dcpl=dcpl)
            else:
                g.create_dataset("x", data=data)
    match = {"gzip": "gzip", "shuffle": "shuffle",
             "latest": "superblock version", "bigendian": "big-endian",
             "track_order": "version-2 object header",
             "compact": "compact", "not_hdf5": "signature"}[kind]
    with pytest.raises(h5.H5Unsupported, match=match):
        with h5.File(path) as f:
            f["train"]["x"][:]


def test_reads_h5py_chunks_edges_and_scalars(tmp_path):
    """Chunked in two dimensions with ragged edge chunks, a resized
    dataset with unwritten chunks (the fill value), a scalar dataset and
    an array attribute, as h5py writes them."""
    path = str(tmp_path / "chunks.h5")
    a = np.arange(23 * 7, dtype=np.int64).reshape(23, 7)
    with h5py.File(path, "w") as f:
        f.create_dataset("a", data=a, chunks=(5, 3))
        r = f.create_dataset("r", (4, 2), maxshape=(None, 2),
                             dtype=np.float32, chunks=(4, 2))
        r[:] = 1.0
        r.resize((13, 2))
        f["s"] = np.float64(2.5)
        f.attrs["v"] = np.arange(3, dtype=np.int32)
    with h5.File(path) as f, h5py.File(path, "r") as g:
        for name in ("a", "r"):
            np.testing.assert_array_equal(f[name][:], g[name][:])
            np.testing.assert_array_equal(f[name][2:11], g[name][2:11])
        assert f["s"][()] == 2.5
        np.testing.assert_array_equal(f.attrs["v"], g.attrs["v"])
        np.testing.assert_array_equal(
            f["a"].rows([9, 1, 2, 22]), g["a"][[1, 2, 9, 22]][[2, 0, 1, 3]])


@pytest.mark.parametrize("layout", ["vlen", "packed"])
@pytest.mark.parametrize("lazy", [False, True, None])
def test_flow_from_h5_matches_jax(jax_files, layout, lazy):
    path = jax_files[layout]
    kw = dict(batch_size=64, max_in_memory_bytes=1 << 20)
    port = DatasetGenerator(**kw).flow_from_h5(path, "train", lazy=lazy)
    ref = JaxGenerator(**kw).flow_from_h5(path, "train", lazy=lazy)
    assert port.steps_per_epoch == ref.steps_per_epoch
    assert port.num_feats == ref.num_feats == 1
    assert port._lazy == ref._lazy == bool(lazy)
    for seed, ordered in ((0, False), (3, False), (None, True)):
        for g, w in zip(port.epoch(seed=seed, ordered=ordered),
                        ref.epoch(seed=seed, ordered=ordered)):
            for field in ("inputs", "input_lengths", "labels",
                          "label_lengths", "weights", "uids"):
                np.testing.assert_array_equal(getattr(g, field),
                                              getattr(w, field),
                                              err_msg=field)
            assert g.texts == w.texts
    small = DatasetGenerator(max_in_memory_bytes=100).flow_from_h5(
        path, "valid")
    assert small._lazy                      # past the budget: streamed
    with pytest.raises(KeyError, match="no split 'test'"):
        DatasetGenerator().flow_from_h5(path, "test")
