"""Unique name generator (counterpart of paddle_tpu/fluid/unique_name.py)."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key):
        tmp = self.ids[key]
        self.ids[key] += 1
        return "%s_%d" % (key, tmp)


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


@contextlib.contextmanager
def guard(new_generator=None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    try:
        yield
    finally:
        generator = old
