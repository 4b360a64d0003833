"""The buffer sanitizer's named errors and the KV pool's epoch guard:
the port's copy of part of ``paddle_tpu/core/sanitizer.py``.

``FLAGS_sanitizer=buffers`` (or ``all``) turns the checks on: a read of
guarded device state while a step that writes it is in flight, through
a stale epoch, or a decref of a block nobody holds, raises
:class:`BufferLifetimeError` naming the state, the op, the step and the
site.  Off (the default), a guarded site costs one flag read.

In the reference the pages are donated through every dispatch and
re-bound to the returned buffers; here a step writes them in place, and
``begin`` / ``rebind`` bracket that write in the same way, so the epoch
a reader saw tells it whether the pages changed since.

Every trip adds one to the module attribute ``trips`` (the reference's
``sanitizer_trips_total`` counter).  Not in this port: the poisoned
scope husks, the lock sanitizer, the schedule weaver and the
flight-recorder dumps.
"""
from __future__ import annotations

from .flags import FLAGS

__all__ = ["BufferEpochGuard", "BufferLifetimeError", "buffers_on",
           "trip"]

# buffer trips raised in this process
trips = 0


def buffers_on():
    """The buffer checks are on (FLAGS_sanitizer ``buffers`` or
    ``all``)."""
    return FLAGS.sanitizer in ("buffers", "all")


class BufferLifetimeError(RuntimeError):
    """A host access touched guarded device state while a step that
    writes it was in flight, or after it changed under the reader.
    Names the var, the op, the step and the site."""

    def __init__(self, var, op=None, step=None, site=None, epoch=None):
        self.var = var
        self.op = op
        self.step = step
        self.site = site
        self.epoch = epoch
        super().__init__(
            "use-after-donate: the buffer of %r was donated to dispatch"
            " %r (step %s, site %s, epoch %s) and has not been re-bound"
            " — read it through Scope.find_var / after sync_scope() or"
            " the apply commits, or copy the value before the step"
            % (var, op, step, site, epoch))


def trip(var, op=None, step=None, site=None, epoch=None):
    """Count one buffer trip and raise the named
    :class:`BufferLifetimeError`."""
    global trips
    trips += 1
    raise BufferLifetimeError(var, op=op, step=step, site=site, epoch=epoch)


class BufferEpochGuard:
    """The write/re-bind contract for device state outside a scope (the
    serving KV page pool): the owner brackets every step that writes it
    with ``begin()`` / ``rebind()``, and readers validate a previously
    observed ``epoch`` (or a mid-step access) through ``check()``."""

    def __init__(self, name):
        self.name = name
        self.epoch = 0
        self._in_flight = None   # (op, step) while a step owns it

    def begin(self, op, step=None):
        if buffers_on():
            self._in_flight = (op, step)

    def rebind(self):
        if self._in_flight is not None or buffers_on():
            self.epoch += 1
            self._in_flight = None

    def check(self, epoch=None, var=None):
        """Validate a read of the guarded state.  Raises
        :class:`BufferLifetimeError` when a step is in flight, or when
        ``epoch`` (from a prior read) is stale."""
        if not buffers_on():
            return
        name = var or self.name
        if self._in_flight is not None:
            op, step = self._in_flight
            trip(name, op=op, step=step,
                 site="%s (dispatch in flight)" % self.name,
                 epoch=self.epoch)
        if epoch is not None and epoch != self.epoch:
            trip(name, op="rebind", step=None,
                 site="%s (stale epoch %s, current %s)"
                      % (self.name, epoch, self.epoch),
                 epoch=self.epoch)
