"""Unique name generator (ref: python/paddle/fluid/unique_name.py)."""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        i = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{i}"


_generator = UniqueNameGenerator()
_name_scopes = []


def generate(key: str) -> str:
    scope = "".join(s + "/" for s in _name_scopes)
    return scope + _generator(key)


def reset():
    global _generator
    _generator = UniqueNameGenerator()
    _name_scopes.clear()


@contextlib.contextmanager
def guard(new_prefix: str = ""):
    """Temporarily switch to a fresh generator (ref: unique_name.py guard)."""
    global _generator
    old = _generator
    _generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        _generator = old


@contextlib.contextmanager
def name_scope(name: str):
    _name_scopes.append(name)
    try:
        yield
    finally:
        _name_scopes.pop()
