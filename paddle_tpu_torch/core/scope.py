"""Scope: name -> value tree with parent lookup.

Counterpart of ``paddle_tpu/core/scope.py``.  Values are torch tensors
on the executor's device (or host objects); there is no separate
Variable wrapper.  The JAX package's prepared-execution attachments
have no counterpart yet: the port's executor runs every step eagerly
against the scope.
"""
from __future__ import annotations


class Scope:
    def __init__(self, parent=None):
        self._parent = parent
        self._vars = {}

    # --- tree ---
    @property
    def parent(self):
        return self._parent

    # --- vars ---
    def set(self, name, value):
        self._vars[name] = value

    def find_var(self, name):
        """Recursive lookup (reference Scope::FindVar); raises KeyError
        if the name exists nowhere."""
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        raise KeyError(name)

    def has_var(self, name):
        return self.find_scope_of(name) is not None

    def find_scope_of(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s
            s = s._parent
        return None

    def __contains__(self, name):
        return self.has_var(name)


_global_scope = Scope()


def global_scope():
    return _global_scope
