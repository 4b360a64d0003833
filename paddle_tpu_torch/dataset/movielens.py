"""MovieLens-1M ratings (parity: python/paddle/dataset/movielens.py —
MovieInfo/UserInfo metadata, train()/test() yielding
[user_id, gender_id, age_index, job_id, movie_id, category_ids,
title_ids, [rating]] with rating rescaled to [-5, 5]).

Parses the real ml-1m zip when cached; otherwise a deterministic
synthetic catalog + latent-factor rating generator (ratings follow a
low-rank user x movie model), so the recommender genuinely converges.

The port's own copy of ``paddle_tpu/dataset/movielens.py``.
"""
from __future__ import annotations

import random
import re
import zipfile

import numpy as np

from . import common

__all__ = [
    "train", "test", "get_movie_title_dict", "max_movie_id", "max_user_id",
    "max_job_id", "age_table", "movie_categories", "user_info", "movie_info",
    "MovieInfo", "UserInfo", "is_synthetic",
]

URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

age_table = [1, 18, 25, 35, 45, 50, 56]

_SYN_USERS = 120
_SYN_MOVIES = 180
_SYN_CATEGORIES = ["Action", "Comedy", "Drama", "Horror", "Romance",
                   "SciFi", "Thriller", "Animation"]
_SYN_TITLE_VOCAB = 60
_SYN_RATINGS = 2400
_SYN_JOBS = 8


class MovieInfo(object):
    """Movie metadata (reference movielens.py:44)."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        """[movie_id, category ids, lower-cased title word ids]."""
        return [self.index,
                [CATEGORIES_DICT[c] for c in self.categories],
                [MOVIE_TITLE_DICT[w.lower()] for w in self.title.split()]]

    def __str__(self):
        return "<MovieInfo id(%d), title(%s), categories(%s)>" % (
            self.index, self.title, self.categories)

    __repr__ = __str__


class UserInfo(object):
    """User metadata (reference movielens.py:71)."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        """[user_id, gender id, age bucket index, job id]."""
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __str__(self):
        return "<UserInfo id(%d), gender(%s), age(%d), job(%d)>" % (
            self.index, "M" if self.is_male else "F",
            age_table[self.age], self.job_id)

    __repr__ = __str__


MOVIE_INFO = None
MOVIE_TITLE_DICT = None
CATEGORIES_DICT = None
USER_INFO = None
_RATINGS = None  # list of (uid, mov_id, rating); synthetic path only


def _init_synthetic():
    global MOVIE_INFO, MOVIE_TITLE_DICT, CATEGORIES_DICT, USER_INFO, _RATINGS
    if MOVIE_INFO is not None:
        return
    CATEGORIES_DICT = {c: i for i, c in enumerate(_SYN_CATEGORIES)}
    MOVIE_TITLE_DICT = {"t%02d" % i: i for i in range(_SYN_TITLE_VOCAB)}
    rng = np.random.RandomState(31)
    MOVIE_INFO = {}
    for mid in range(1, _SYN_MOVIES + 1):
        n_cat = int(rng.randint(1, 4))
        cats = [_SYN_CATEGORIES[i] for i in
                rng.choice(len(_SYN_CATEGORIES), n_cat, replace=False)]
        n_tw = int(rng.randint(1, 5))
        title = " ".join("t%02d" % w for w in
                         rng.randint(0, _SYN_TITLE_VOCAB, n_tw))
        MOVIE_INFO[mid] = MovieInfo(index=mid, categories=cats, title=title)
    USER_INFO = {}
    for uid in range(1, _SYN_USERS + 1):
        USER_INFO[uid] = UserInfo(
            index=uid, gender="M" if rng.rand() < 0.5 else "F",
            age=age_table[int(rng.randint(0, len(age_table)))],
            job_id=int(rng.randint(0, _SYN_JOBS)))
    # latent-angle preference model: rating tracks the cosine between a
    # user vector and a movie vector — the same functional form the
    # book's dual-tower cos_sim recommender predicts, so it can fit it
    k = 4
    uvec = rng.randn(_SYN_USERS + 1, k)
    mvec = rng.randn(_SYN_MOVIES + 1, k)
    uvec /= np.linalg.norm(uvec, axis=1, keepdims=True)
    mvec /= np.linalg.norm(mvec, axis=1, keepdims=True)
    _RATINGS = []
    for _ in range(_SYN_RATINGS):
        uid = int(rng.randint(1, _SYN_USERS + 1))
        mid = int(rng.randint(1, _SYN_MOVIES + 1))
        cos = float(uvec[uid] @ mvec[mid])
        raw = 3.0 + 2.5 * cos + float(rng.randn()) * 0.15
        _RATINGS.append((uid, mid, min(5.0, max(1.0, round(raw)))))


def _init_real():
    global MOVIE_INFO, MOVIE_TITLE_DICT, CATEGORIES_DICT, USER_INFO
    fn = common.download(URL, "movielens", MD5)
    if MOVIE_INFO is None:
        pattern = re.compile(r"^(.*)\((\d+)\)$")
        with zipfile.ZipFile(file=fn) as package:
            MOVIE_INFO = {}
            title_word_set, categories_set = set(), set()
            with package.open("ml-1m/movies.dat") as movie_file:
                for line in movie_file:
                    line = line.decode("latin-1")
                    movie_id, title, categories = line.strip().split("::")
                    categories = categories.split("|")
                    categories_set.update(categories)
                    title = pattern.match(title).group(1)
                    MOVIE_INFO[int(movie_id)] = MovieInfo(
                        index=movie_id, categories=categories, title=title)
                    title_word_set.update(
                        w.lower() for w in title.split())
            MOVIE_TITLE_DICT = {w: i for i, w in enumerate(title_word_set)}
            CATEGORIES_DICT = {c: i for i, c in enumerate(categories_set)}
            USER_INFO = {}
            with package.open("ml-1m/users.dat") as user_file:
                for line in user_file:
                    line = line.decode("latin-1")
                    uid, gender, age, job, _ = line.strip().split("::")
                    USER_INFO[int(uid)] = UserInfo(
                        index=uid, gender=gender, age=age, job_id=job)
    return fn


_IS_SYNTHETIC = None


def is_synthetic():
    global _IS_SYNTHETIC
    if _IS_SYNTHETIC is None:
        try:
            common.download(URL, "movielens", MD5)
            _IS_SYNTHETIC = False
        except (FileNotFoundError, IOError):
            _IS_SYNTHETIC = True
    return _IS_SYNTHETIC


def _initialize():
    if is_synthetic():
        _init_synthetic()
        return None
    return _init_real()


def __reader__(rand_seed=0, test_ratio=0.1, is_test=False):
    fn = _initialize()
    rand = random.Random(x=rand_seed)
    if fn is None:  # synthetic
        for uid, mid, rating in _RATINGS:
            if (rand.random() < test_ratio) == is_test:
                yield (USER_INFO[uid].value() + MOVIE_INFO[mid].value()
                       + [[rating * 2 - 5.0]])
        return
    with zipfile.ZipFile(file=fn) as package:
        with package.open("ml-1m/ratings.dat") as rating_file:
            for line in rating_file:
                line = line.decode("latin-1")
                if (rand.random() < test_ratio) == is_test:
                    uid, mov_id, rating, _ = line.strip().split("::")
                    uid, mov_id = int(uid), int(mov_id)
                    rating = float(rating) * 2 - 5.0
                    yield (USER_INFO[uid].value()
                           + MOVIE_INFO[mov_id].value() + [[rating]])


def __reader_creator__(**kwargs):
    return lambda: __reader__(**kwargs)


def train():
    return __reader_creator__(is_test=False)


def test():
    return __reader_creator__(is_test=True)


def get_movie_title_dict():
    _initialize()
    return MOVIE_TITLE_DICT


def max_movie_id():
    _initialize()
    return max(MOVIE_INFO.keys())


def max_user_id():
    _initialize()
    return max(USER_INFO.keys())


def max_job_id():
    _initialize()
    return max(u.job_id for u in USER_INFO.values())


def movie_categories():
    _initialize()
    return CATEGORIES_DICT


def user_info():
    _initialize()
    return USER_INFO


def movie_info():
    _initialize()
    return MOVIE_INFO
