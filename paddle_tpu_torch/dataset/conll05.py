"""CoNLL-2005 semantic-role-labeling dataset (parity:
python/paddle/dataset/conll05.py — get_dict() returning word/verb/label
dicts, test() yielding the db_lstm 9-tuple: word ids, 5 context-window
feature id lists, predicate ids, mark flags, label ids).

Parses the real conll05st test split when cached; otherwise a
deterministic synthetic corpus whose labels correlate with word identity
and distance to the predicate, so the SRL model genuinely learns.

The port's own copy of ``paddle_tpu/dataset/conll05.py``.
"""
from __future__ import annotations

import gzip

import numpy as np

from . import common

__all__ = ["get_dict", "get_embedding", "test", "is_synthetic"]

DATA_URL = ("http://www.cs.upc.edu/~srlconll/conll05st-tests.tar.gz")
DATA_MD5 = "387719152ae52d60422c016e92a742fc"
WORDDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st%2FwordDict.txt")
VERBDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st%2FverbDict.txt")
TRGDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st%2FtargetDict.txt")
EMB_URL = "http://paddlemodels.bj.bcebos.com/conll05st%2Femb"

UNK_IDX = 0

_SYN_WORDS = 300
_SYN_VERBS = 30
_SYN_ROLES = ["A0", "A1", "A2", "AM-TMP", "AM-LOC"]
_SYN_SENTS = 400


_IS_SYNTHETIC = None


def is_synthetic():
    """True unless EVERY required file (three dicts + the test tarball)
    is cached — a partial cache must still fall back, not crash."""
    global _IS_SYNTHETIC
    if _IS_SYNTHETIC is None:
        try:
            for url, md5 in ((WORDDICT_URL, None), (VERBDICT_URL, None),
                             (TRGDICT_URL, None), (DATA_URL, DATA_MD5)):
                common.download(url, "conll05st", md5)
            _IS_SYNTHETIC = False
        except (FileNotFoundError, IOError):
            _IS_SYNTHETIC = True
    return _IS_SYNTHETIC


def _synthetic_dicts():
    word_dict = {"w%03d" % i: i for i in range(_SYN_WORDS)}
    word_dict["bos"] = _SYN_WORDS
    word_dict["eos"] = _SYN_WORDS + 1
    verb_dict = {"v%02d" % i: i for i in range(_SYN_VERBS)}
    labels = ["O", "B-V", "I-V"]
    for r in _SYN_ROLES:
        labels += ["B-" + r, "I-" + r]
    label_dict = {l: i for i, l in enumerate(labels)}
    return word_dict, verb_dict, label_dict


def load_label_dict(filename):
    d = {}
    tag_dict = set()
    with open(filename, "r") as f:
        for line in f:
            line = line.strip()
            if line.startswith("B-"):
                tag_dict.add(line[2:])
            elif line.startswith("I-"):
                tag_dict.add(line[2:])
        # reference id layout (conll05.py:44-61): tag ids first from 0,
        # "O" LAST — artifacts trained against the published dicts
        # (embeddings, CRF transitions) depend on it.  Deviation: tags
        # are sorted here (the reference iterates a set, whose order is
        # itself unstable across interpreter runs).
        index = 0
        for tag in sorted(tag_dict):
            d["B-" + tag] = index
            index += 1
            d["I-" + tag] = index
            index += 1
        d["O"] = index
    return d


def load_dict(filename):
    d = {}
    with open(filename, "r") as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def get_dict():
    """(word_dict, verb_dict, label_dict) (reference conll05.py:201)."""
    if is_synthetic():
        return _synthetic_dicts()
    word_dict = load_dict(common.download(WORDDICT_URL, "conll05st"))
    verb_dict = load_dict(common.download(VERBDICT_URL, "conll05st"))
    label_dict = load_label_dict(common.download(TRGDICT_URL, "conll05st"))
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Path of the pre-trained word embedding file."""
    return common.download(EMB_URL, "conll05st")


def _synthetic_corpus():
    """(sentence words, predicate, BIO labels) triples.  The label of a
    word depends on its id parity and signed distance to the predicate —
    enough structure for the CRF to beat the trivial all-O guess."""
    rng = np.random.RandomState(47)
    for _ in range(_SYN_SENTS):
        length = int(rng.randint(5, 18))
        words = ["w%03d" % int(i) for i in rng.randint(0, _SYN_WORDS, length)]
        vi = int(rng.randint(0, length))
        verb = "v%02d" % int(rng.randint(0, _SYN_VERBS))
        labels = []
        for i in range(length):
            if i == vi:
                labels.append("B-V")
                continue
            role = _SYN_ROLES[int(words[i][1:]) % len(_SYN_ROLES)]
            prev_same = (labels and labels[-1].endswith(role)
                         and labels[-1] != "B-V")
            labels.append(("I-" if prev_same else "B-") + role)
        yield words, verb, labels


def _props_column_to_bio(column):
    """One predicate's props column (CoNLL-2005 span notation: ``(A0*``,
    ``*``, ``*)``, ``(V*)``) -> a BIO tag sequence."""
    bio = []
    open_tag = None
    for cell in column:
        starts = cell.startswith("(")
        ends = cell.endswith(")")
        if starts:
            open_tag = cell[1:cell.index("*")]
            bio.append("B-" + open_tag)
        elif open_tag is not None:
            bio.append("I-" + open_tag)
        else:
            bio.append("O")
        if ends:
            open_tag = None
    return bio


def corpus_reader(data_path=None, words_name=None, props_name=None):
    """Real-path corpus reader over the conll05st tarball (reference
    conll05.py:72) — yields (sentence words, predicate, BIO labels), one
    item per predicate column in the props file."""
    import tarfile

    def flush(words, prop_rows):
        if not prop_rows:
            return
        verbs = [v for v in (r[0] for r in prop_rows) if v != "-"]
        n_preds = len(prop_rows[0]) - 1
        for k in range(n_preds):
            column = [r[k + 1] for r in prop_rows]
            yield words, verbs[k], _props_column_to_bio(column)

    def reader():
        with tarfile.open(data_path) as tf:
            wf = gzip.GzipFile(fileobj=tf.extractfile(words_name))
            pf = gzip.GzipFile(fileobj=tf.extractfile(props_name))
            words, prop_rows = [], []
            # plain zip: the files are parallel by format; stopping at
            # the shorter one beats crashing on a padded None
            for wline, pline in zip(wf, pf):
                pcells = pline.strip().decode("utf-8").split()
                if not pcells:  # blank line = sentence boundary
                    yield from flush(words, prop_rows)
                    words, prop_rows = [], []
                    continue
                words.append(wline.strip().decode("utf-8"))
                prop_rows.append(pcells)
            # no trailing blank line: don't drop the last sentence
            yield from flush(words, prop_rows)

    return reader


def reader_creator(corpus_reader, word_dict=None, predicate_dict=None,
                   label_dict=None):
    """db_lstm feature extraction (reference conll05.py:146): context
    windows around the predicate, mark flags, id lookups."""

    def reader():
        for sentence, predicate, labels in corpus_reader():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)
            if verb_index > 0:
                mark[verb_index - 1] = 1
                ctx_n1 = sentence[verb_index - 1]
            else:
                ctx_n1 = "bos"
            if verb_index > 1:
                mark[verb_index - 2] = 1
                ctx_n2 = sentence[verb_index - 2]
            else:
                ctx_n2 = "bos"
            mark[verb_index] = 1
            ctx_0 = sentence[verb_index]
            if verb_index < len(labels) - 1:
                mark[verb_index + 1] = 1
                ctx_p1 = sentence[verb_index + 1]
            else:
                ctx_p1 = "eos"
            if verb_index < len(labels) - 2:
                mark[verb_index + 2] = 1
                ctx_p2 = sentence[verb_index + 2]
            else:
                ctx_p2 = "eos"

            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            ctx_n2_idx = [word_dict.get(ctx_n2, UNK_IDX)] * sen_len
            ctx_n1_idx = [word_dict.get(ctx_n1, UNK_IDX)] * sen_len
            ctx_0_idx = [word_dict.get(ctx_0, UNK_IDX)] * sen_len
            ctx_p1_idx = [word_dict.get(ctx_p1, UNK_IDX)] * sen_len
            ctx_p2_idx = [word_dict.get(ctx_p2, UNK_IDX)] * sen_len
            pred_idx = [predicate_dict.get(predicate, 0)] * sen_len
            # unknown labels fall back to "O" (its id is LAST in the
            # reference layout, not 0 — 0 is the first B- tag)
            o_id = label_dict.get("O", 0)
            label_idx = [label_dict.get(w, o_id) for w in labels]

            yield (word_idx, ctx_n2_idx, ctx_n1_idx, ctx_0_idx, ctx_p1_idx,
                   ctx_p2_idx, pred_idx, mark, label_idx)

    return reader


def test():
    word_dict, verb_dict, label_dict = get_dict()
    if is_synthetic():
        return reader_creator(_synthetic_corpus, word_dict=word_dict,
                              predicate_dict=verb_dict,
                              label_dict=label_dict)
    reader = corpus_reader(
        common.download(DATA_URL, "conll05st", DATA_MD5),
        words_name="conll05st-release/test.wsj/words/test.wsj.words.gz",
        props_name="conll05st-release/test.wsj/props/test.wsj.props.gz")
    return reader_creator(reader, word_dict=word_dict,
                          predicate_dict=verb_dict, label_dict=label_dict)
