"""Scope: name -> value tree with parent lookup.

Counterpart of ``paddle_tpu/core/scope.py``.  Values are torch tensors
on the executor's device (or host objects); there is no separate
Variable wrapper.

The prepared-execution attachments are ported as in the JAX package:
every ``set`` bumps the scope's ``_version`` and the name's
write version, which a ``PreparedProgram`` (``core/executor_impl.py``)
watches to re-stage its device-resident state and to tell its own
write-backs from someone else's; and ``find_var`` flushes every dirty
prepared program attached to a scope on the lookup chain before it
reads, so a reader never sees a value the device has moved past.
"""
from __future__ import annotations

import weakref


class Scope:
    def __init__(self, parent=None):
        self._parent = parent
        self._vars = {}
        # bumped on every write: a PreparedProgram watches the
        # chain sum (chain_version) to know when to re-stage its state,
        # and the per-name write version to tell its own write-backs
        # from external writes (an external write always wins)
        self._version = 0
        self._write_versions = {}
        # weakrefs to prepared programs (``._dirty`` + ``.sync_scope()``)
        # whose device-resident state is flushed before any read here
        self._prepared_registry = None
        self._in_flush = False

    # --- tree ---
    @property
    def parent(self):
        return self._parent

    def new_scope(self):
        return Scope(self)

    # --- vars ---
    def var(self, name):
        """Find-or-create in THIS scope (reference Scope::Var)."""
        if name not in self._vars:
            self._vars[name] = None
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value
        self._version += 1
        self._write_versions[name] = self._version

    def erase(self, names):
        """Drop ``names`` from this scope (the delete_var op)."""
        removed = False
        for n in names:
            if n in self._vars:
                del self._vars[n]
                self._write_versions.pop(n, None)
                removed = True
        if removed:  # a no-op erase must not force prepared re-stages
            self._version += 1

    def find_var(self, name):
        """Recursive lookup (reference Scope::FindVar); raises KeyError
        if the name exists nowhere.  Flushes the attached prepared state
        of each scope on the way first."""
        s = self
        while s is not None:
            if s._prepared_registry is not None:
                s.flush_prepared()
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        raise KeyError(name)

    def flush_prepared(self, exclude=None):
        """sync_scope() every dirty prepared program attached to THIS
        scope but ``exclude``.  Dead weakrefs are pruned; re-entry is a
        no-op."""
        reg = self._prepared_registry
        if not reg or self._in_flush:
            return
        self._in_flush = True
        try:
            live = []
            for ref in reg:
                p = ref()
                if p is None:
                    continue
                live.append(ref)
                if p is not exclude and p._dirty:
                    p.sync_scope()
            if len(live) != len(reg):
                reg[:] = live
        finally:
            self._in_flush = False

    def attach_prepared(self, prep):
        """Register ``prep`` (has ``._dirty`` and ``.sync_scope()``) for
        read-time flushing on this scope."""
        if self._prepared_registry is None:
            self._prepared_registry = []
        self._prepared_registry.append(weakref.ref(prep))

    def chain_version(self):
        """Sum of versions up the parent chain: any write visible to a
        lookup from this scope changes it."""
        v = 0
        s = self
        while s is not None:
            v += s._version
            s = s._parent
        return v

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
