"""The port's dataset adapters (``paddle_tpu_torch/dataset``) against the
JAX package's, on their synthetic paths: every sample of every reader,
every dictionary and metadata table equal; ``common.download`` raises
FileNotFoundError for a file that is not cached, opens no connection
and creates no directory; a cached file is found and its md5 checked;
``split`` and ``cluster_files_reader`` as the reference's."""
import pickle
import socket

import pytest

from paddle_tpu import dataset as jdata
from paddle_tpu_torch import dataset as tdata


def _samples(reader):
    return [tuple(tuple(x) if isinstance(x, list) else x for x in s)
            for s in reader()]


READERS = {
    "wmt14_train_80": lambda d: d.wmt14.train(80),
    "wmt14_test_80": lambda d: d.wmt14.test(80),
    "wmt14_train_10000": lambda d: d.wmt14.train(10000),
    "movielens_train": lambda d: d.movielens.train(),
    "movielens_test": lambda d: d.movielens.test(),
    "conll05_test": lambda d: d.conll05.test(),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_yields_the_references_samples(name):
    want = _samples(READERS[name](jdata))
    got = _samples(READERS[name](tdata))
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("module", ["wmt14", "movielens", "conll05"])
def test_adapter_is_synthetic_offline(module):
    assert getattr(tdata, module).is_synthetic() is True
    assert getattr(jdata, module).is_synthetic() is True


@pytest.mark.parametrize("dict_size,reverse", [(80, True), (80, False),
                                               (10000, True)])
def test_wmt14_dicts(dict_size, reverse):
    assert tdata.wmt14.get_dict(dict_size, reverse) == \
        jdata.wmt14.get_dict(dict_size, reverse)


def test_movielens_metadata():
    """The sizes the recommender reads at build time, and every user's
    and movie's values."""
    for fn in ("max_user_id", "max_movie_id", "max_job_id",
               "movie_categories", "get_movie_title_dict"):
        assert getattr(tdata.movielens, fn)() == \
            getattr(jdata.movielens, fn)(), fn
    assert tdata.movielens.age_table == jdata.movielens.age_table
    tu, ju = tdata.movielens.user_info(), jdata.movielens.user_info()
    assert sorted(tu) == sorted(ju)
    assert all(tu[k].value() == ju[k].value() for k in ju)
    tm, jm = tdata.movielens.movie_info(), jdata.movielens.movie_info()
    assert sorted(tm) == sorted(jm)
    assert all(tm[k].value() == jm[k].value() and str(tm[k]) == str(jm[k])
               for k in jm)


def test_conll05_dicts():
    assert tdata.conll05.get_dict() == jdata.conll05.get_dict()


def test_download_raises_for_an_uncached_file_and_never_fetches(
        tmp_path, monkeypatch):
    """No socket is opened and no directory made: the lookup is a path
    check that raises FileNotFoundError naming the URL."""
    def refuse(*a, **k):
        raise AssertionError("download opened a connection")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    home = tmp_path / "data"
    monkeypatch.setattr(tdata.common, "DATA_HOME", str(home))
    url = "http://example.invalid/some/file.tgz"
    with pytest.raises(FileNotFoundError, match="file.tgz"):
        tdata.common.download(url, "mod", "0" * 32)
    assert not home.exists()


def test_download_finds_a_cached_file_and_checks_its_md5(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(tdata.common, "DATA_HOME", str(tmp_path))
    (tmp_path / "mod").mkdir()
    path = tmp_path / "mod" / "file.tgz"
    path.write_bytes(b"abc")
    md5 = tdata.common.md5file(str(path))
    assert md5 == jdata.common.md5file(str(path))
    url = "http://example.invalid/file.tgz"
    assert tdata.common.download(url, "mod", md5) == str(path)
    assert tdata.common.download(url, "mod") == str(path)
    with pytest.raises(IOError, match="md5 mismatch"):
        tdata.common.download(url, "mod", "0" * 32)


def test_split_and_cluster_files_reader(tmp_path):
    """split writes the reference's part-files; each trainer's reader
    yields its share of them, as the reference's."""
    def reader():
        yield from range(23)

    n = tdata.common.split(reader, 5, suffix=str(tmp_path / "t%05d.pickle"))
    m = jdata.common.split(reader, 5, suffix=str(tmp_path / "j%05d.pickle"))
    assert n == m == 5
    for i in range(n):
        with open(tmp_path / ("t%05d.pickle" % i), "rb") as a, \
                open(tmp_path / ("j%05d.pickle" % i), "rb") as b:
            assert pickle.load(a) == pickle.load(b)
    for tid in range(2):
        got = list(tdata.common.cluster_files_reader(
            str(tmp_path / "t*.pickle"), 2, tid)())
        want = list(jdata.common.cluster_files_reader(
            str(tmp_path / "j*.pickle"), 2, tid)())
        assert got == want and got
