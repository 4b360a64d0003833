"""Operator registry of the port.

Counterpart of ``paddle_tpu/core/registry.py`` with the same ``OpInfo``
fields; the table is the port's own.  An op is:

- ``lower(ctx, ins, attrs, op) -> outs``: eager PyTorch code over the
  op's input tensors (``ins`` maps slot -> list of tensors).  It runs as
  it is on the CPU, on the card and on ``meta`` tensors (build-time
  shape inference).
- ``grad_maker``: the build-time autodiff hook, unchanged ("default" ->
  the generic ``<type>_grad`` desc; None -> not differentiable).  A
  ``<type>_grad`` without an explicit registration lowers through
  ``lowering.generic_grad_lower`` (torch.autograd over the forward
  lowering, or the forward's ``grad_lower`` where it has one).
- ``infer_shape``: optional ``fn(ins, attrs, op) -> {slot: tensors}``
  over ``meta`` tensors, for ops whose lowering must not see them (a
  kernel wrapper rejects ``meta``).
"""
from __future__ import annotations


class OpInfo:
    __slots__ = ("type", "lower", "grad_maker", "grad_lower", "infer_shape",
                 "host_op", "stateful", "wrt", "no_vjp_outputs", "seq_aware")

    def __init__(self, type_, lower=None, grad_maker="default",
                 grad_lower=None, infer_shape=None, host_op=False,
                 stateful=False, wrt=None, no_vjp_outputs=(),
                 seq_aware=False):
        self.type = type_
        self.lower = lower
        # "default" -> generic maker; None -> non-differentiable;
        # callable -> custom
        self.grad_maker = grad_maker
        self.grad_lower = grad_lower
        self.infer_shape = infer_shape
        self.host_op = host_op          # executed on host by the Executor
        self.stateful = stateful        # draws random numbers
        # slots to differentiate w.r.t.; None = all floating-point inputs
        self.wrt = wrt
        # output slots excluded from the vjp (integer/aux outputs)
        self.no_vjp_outputs = tuple(no_vjp_outputs)
        # op manages sequence lengths itself
        self.seq_aware = seq_aware


_registry = {}


def register_op(type_, **kwargs):
    """Register an op.  Usable directly or as a decorator on the lowering."""

    def _do(lower):
        if type_ in _registry:
            raise ValueError("op %r already registered" % type_)
        _registry[type_] = OpInfo(type_, lower=lower, **kwargs)
        return lower

    if "lower" in kwargs:
        lower = kwargs.pop("lower")
        return _do(lower)
    return _do


def get_op_info(type_):
    info = _registry.get(type_)
    if info is None and type_.endswith("_grad") and \
            type_[: -len("_grad")] in _registry:
        # synthesise the grad op from the forward lowering (autograd);
        # registered lazily so explicit grad lowerings take precedence
        from . import lowering  # local import: registry <-> lowering cycle

        info = OpInfo(type_, lower=lowering.generic_grad_lower,
                      grad_maker=None)
        _registry[type_] = info
    if info is None:
        raise KeyError("operator %r is not registered (registered: %d ops)" %
                       (type_, len(_registry)))
    return info


def has_op(type_):
    return type_ in _registry


def registered_ops():
    return sorted(_registry.keys())
