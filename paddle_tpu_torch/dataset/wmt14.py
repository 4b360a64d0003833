"""WMT-14 French->English translation (parity:
python/paddle/dataset/wmt14.py — train(dict_size)/test(dict_size)
yielding (src ids with <s>/<e>, trg ids with <s>, shifted trg ids),
get_dict(dict_size) returning id->word maps).

Parses the real preprocessed tarball when cached; otherwise a
deterministic synthetic parallel corpus where the target is a fixed
token-level permutation-cipher of the source, so attention/seq2seq
models genuinely learn alignment.

The port's own copy of ``paddle_tpu/dataset/wmt14.py``.
"""
from __future__ import annotations

import tarfile

import numpy as np

from . import common

__all__ = ["train", "test", "get_dict", "START", "END", "UNK", "UNK_IDX",
           "is_synthetic"]

URL_TRAIN = ("http://paddlepaddle.cdn.bcebos.com/demo/wmt_shrinked_data/"
             "wmt14.tgz")
MD5_TRAIN = "0791583d57d5beb693b9414c5b36798c"

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

_SYN_SENTS_TRAIN = 400
_SYN_SENTS_TEST = 60


_IS_SYNTHETIC = None


def is_synthetic():
    global _IS_SYNTHETIC
    if _IS_SYNTHETIC is None:
        try:
            common.download(URL_TRAIN, "wmt14", MD5_TRAIN)
            _IS_SYNTHETIC = False
        except (FileNotFoundError, IOError):
            _IS_SYNTHETIC = True
    return _IS_SYNTHETIC


def _syn_vocab(dict_size):
    # ids 0/1/2 are reserved exactly like the real dicts
    words = [START, END, UNK] + ["tok%04d" % i for i in range(dict_size - 3)]
    return {w: i for i, w in enumerate(words)}


def _synthetic_reader(dict_size, n_sents, seed):
    """Target = source mapped through a fixed permutation of the vocab
    (a learnable word-for-word 'translation')."""
    def reader():
        rng = np.random.RandomState(seed)
        content = dict_size - 3  # non-reserved ids
        perm = np.random.RandomState(9).permutation(content)
        for _ in range(n_sents):
            length = int(rng.randint(3, 12))
            src = rng.randint(0, content, length)
            trg = perm[src]
            src_ids = [0] + (src + 3).tolist() + [1]
            trg_core = (trg + 3).tolist()
            yield src_ids, [0] + trg_core, trg_core + [1]

    return reader


def __read_to_dict(tar_file, dict_size):
    def to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.strip().decode("utf-8")] = i
        return out

    with tarfile.open(tar_file) as f:
        names = [n for n in f.getnames() if n.endswith("src.dict")]
        assert len(names) == 1
        src_dict = to_dict(f.extractfile(names[0]), dict_size)
        names = [n for n in f.getnames() if n.endswith("trg.dict")]
        assert len(names) == 1
        trg_dict = to_dict(f.extractfile(names[0]), dict_size)
    return src_dict, trg_dict


def reader_creator(tar_file, file_name, dict_size):
    def reader():
        src_dict, trg_dict = __read_to_dict(tar_file, dict_size)
        with tarfile.open(tar_file) as f:
            names = [n for n in f.getnames() if n.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    line_split = line.strip().decode("utf-8").split("\t")
                    if len(line_split) != 2:
                        continue
                    src_words = line_split[0].split()
                    src_ids = [src_dict.get(w, UNK_IDX)
                               for w in [START] + src_words + [END]]
                    trg_words = line_split[1].split()
                    trg_ids = [trg_dict.get(w, UNK_IDX) for w in trg_words]
                    trg_ids_next = trg_ids + [trg_dict[END]]
                    trg_ids = [trg_dict[START]] + trg_ids
                    yield src_ids, trg_ids, trg_ids_next

    return reader


def train(dict_size):
    if is_synthetic():
        return _synthetic_reader(dict_size, _SYN_SENTS_TRAIN, seed=3)
    return reader_creator(common.download(URL_TRAIN, "wmt14", MD5_TRAIN),
                          "train/train", dict_size)


def test(dict_size):
    if is_synthetic():
        return _synthetic_reader(dict_size, _SYN_SENTS_TEST, seed=5)
    return reader_creator(common.download(URL_TRAIN, "wmt14", MD5_TRAIN),
                          "test/test", dict_size)


def get_dict(dict_size, reverse=True):
    """(src, trg) dicts; id->word when ``reverse`` (the decoder's view)."""
    if is_synthetic():
        src_dict = trg_dict = _syn_vocab(dict_size)
    else:
        tar_file = common.download(URL_TRAIN, "wmt14", MD5_TRAIN)
        src_dict, trg_dict = __read_to_dict(tar_file, dict_size)
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict
