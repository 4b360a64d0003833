"""append_backward: build-time reverse-mode autodiff over the op graph.

Counterpart of paddle_tpu/fluid/backward.py.  The per-op grad ops it
emits default to `<type>_grad` descs whose lowering differentiates the
forward lowering with torch.autograd (core/lowering.py:
generic_grad_lower), so the emitted graph is the JAX package's, op for
op.

Duplicate gradient contributions (a var consumed by several ops) are renamed
``v@GRAD@RENAME@k`` and summed with a `sum` op right before first use, as in
the reference.
"""
from __future__ import annotations

from collections import defaultdict

from paddle_tpu_torch.core import desc as core_desc
from paddle_tpu_torch.core.registry import get_op_info, has_op
from paddle_tpu_torch.core.types import (dtype_is_floating,
                                         proto_to_np_dtype)

from .framework import Variable, OpRole, grad_var_name, Operator

__all__ = ["append_backward", "calc_gradient"]


def _default_grad_op_desc(op_desc, block_desc, no_grad_set, out_grad_map):
    """Build `<type>_grad` consuming fwd ins/outs + out grads, producing
    in grads with "" holes for non-differentiable inputs."""
    inputs = {}
    for slot, names in op_desc.inputs.items():
        inputs[slot] = list(names)
    for slot, names in op_desc.outputs.items():
        if slot in inputs:
            continue  # rare alias; forward inputs win
        inputs[slot] = list(names)
    for slot, names in op_desc.outputs.items():
        gnames = []
        any_grad = False
        for n in names:
            if n in out_grad_map:
                gnames.append(out_grad_map[n])
                any_grad = True
            else:
                gnames.append("")
        if any_grad:
            inputs[slot + "@GRAD"] = gnames

    outputs = {}
    grad_to_var = {}
    for slot, names in op_desc.inputs.items():
        gnames = []
        for n in names:
            vd = block_desc.find_var_recursive(n) if n else None
            diff = (n and n not in no_grad_set and vd is not None
                    and dtype_is_floating(vd.dtype)
                    and not vd.stop_gradient)
            if diff:
                g = grad_var_name(n)
                gnames.append(g)
                grad_to_var[g] = n
            else:
                gnames.append("")
        if any(g for g in gnames):
            outputs[slot + "@GRAD"] = gnames
    if not outputs:
        return None, {}
    g = core_desc.OpDesc(op_desc.type + "_grad", inputs, outputs,
                         {k: a.value for k, a in op_desc.attrs.items()},
                         role=OpRole.Backward)
    return g, grad_to_var


def _make_grad_ops(op, block, no_grad_set, out_grad_map):
    info = get_op_info(op.desc.type)
    if info.grad_maker is None:
        return [], {}
    if info.grad_maker == "default":
        g, g2v = _default_grad_op_desc(op.desc, block.desc, no_grad_set,
                                       out_grad_map)
        return ([g], g2v) if g is not None else ([], {})
    # custom maker writes canonical names; rewrite renamed out-grads after
    descs, g2v = info.grad_maker(op.desc, block.desc, no_grad_set)
    for gdesc in descs:
        gdesc.role = OpRole.Backward
        for o, mapped in out_grad_map.items():
            canonical = grad_var_name(o)
            if mapped != canonical:
                gdesc.rename_input(canonical, mapped)
    return descs, g2v


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append grad ops for every op on the path to `loss`; returns
    [(param, grad_var)] for trainable parameters."""
    assert isinstance(loss, Variable)
    program = loss.block.program
    block = loss.block
    bdesc = block.desc

    # Appending backward twice (a second minimize / calc_gradient on the
    # same program) would duplicate grad ops and silently corrupt
    # gradients — fail loudly instead.
    done = getattr(program, "_backward_applied_for", set())
    if done:
        raise RuntimeError(
            "append_backward already ran on this program (for %s); clone "
            "the program to build another backward pass" % sorted(done))
    done.add(loss.name)
    program._backward_applied_for = done

    no_grad = set(no_grad_set or [])
    for name, vd in bdesc.vars.items():
        if vd.stop_gradient:
            no_grad.add(name)

    ops = list(block.ops)
    # only ops up to the loss producer matter
    loss_idx = None
    for i in reversed(range(len(ops))):
        if loss.name in ops[i].desc.output_arg_names():
            loss_idx = i
            break
    if loss_idx is None:
        raise ValueError("loss %r is not produced by any op" % loss.name)
    ops[loss_idx].desc.role |= OpRole.Loss
    program.desc.bump_version()

    # loss@GRAD = 1
    loss_grad = grad_var_name(loss.name)
    _ensure_grad_var(block, loss_grad, loss.name)
    fill = core_desc.OpDesc(
        "fill_constant", {}, {"Out": [loss_grad]},
        {"shape": [int(d) if d > 0 else 1 for d in (loss.shape or (1,))],
         "dtype": int(loss.desc.dtype), "value": 1.0},
        role=OpRole.Backward)
    appended = [fill]

    contribs = defaultdict(list)
    contribs[loss.name].append(loss_grad)

    for op in reversed(ops[: loss_idx + 1]):
        out_names = [n for n in op.desc.output_arg_names() if n]
        out_grad_map = {}
        for o in dict.fromkeys(out_names):
            lst = contribs.get(o, [])
            if not lst:
                continue
            if len(lst) == 1:
                out_grad_map[o] = lst[0]
            else:
                g = grad_var_name(o)
                appended.append(core_desc.OpDesc(
                    "sum", {"X": list(lst)}, {"Out": [g]}, {},
                    role=OpRole.Backward))
                _ensure_grad_var(block, g, o)
                out_grad_map[o] = g
                contribs[o] = [g]
        if not out_grad_map:
            continue
        if not has_op(op.desc.type):
            continue
        grad_descs, grad_to_var = _make_grad_ops(op, block, no_grad,
                                                 out_grad_map)
        for gdesc in grad_descs:
            # rename duplicate contributions
            for slot, names in gdesc.outputs.items():
                for i, g in enumerate(names):
                    if not g:
                        continue
                    fwd = grad_to_var.get(g, g[: -len("@GRAD")]
                                          if g.endswith("@GRAD") else g)
                    k = len(contribs[fwd])
                    if k > 0:
                        new_g = "%s@RENAME@%d" % (grad_var_name(fwd), k)
                        names[i] = new_g
                        _ensure_grad_var(block, new_g, fwd)
                        contribs[fwd].append(new_g)
                    else:
                        _ensure_grad_var(block, g, fwd)
                        contribs[fwd].append(g)
            appended.append(gdesc)

    # finalize leaf grads (parameters): sum pending duplicates
    for name, lst in list(contribs.items()):
        if len(lst) > 1:
            g = grad_var_name(name)
            appended.append(core_desc.OpDesc(
                "sum", {"X": list(lst)}, {"Out": [g]}, {},
                role=OpRole.Backward))
            _ensure_grad_var(block, g, name)
            contribs[name] = [g]

    for gdesc in appended:
        bdesc.append_op(gdesc)
        block.ops.append(Operator(block, gdesc))
    program.desc.bump_version()

    # collect (param, grad)
    if parameter_list is not None:
        params = [block._var_recursive(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = program.all_parameters()
    params_and_grads = []
    for p in params:
        if not getattr(p, "trainable", True):
            continue
        if p.name in no_grad:
            continue
        gname = contribs.get(p.name)
        if not gname:
            continue
        gvar = block.vars.get(gname[0])
        if gvar is None:
            continue
        params_and_grads.append((p, gvar))
    return params_and_grads


def _ensure_grad_var(block, grad_name_, fwd_name):
    if block.desc.has_var(grad_name_):
        return block.vars.get(grad_name_)
    fwd_vd = block.desc.find_var_recursive(fwd_name)
    return block.create_var(
        name=grad_name_,
        shape=fwd_vd.shape if fwd_vd is not None else (),
        dtype=(proto_to_np_dtype(fwd_vd.dtype) if fwd_vd is not None
               else "float32"))


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of `targets` w.r.t `inputs` (reference backward.py:604)."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if len(targets) != 1:
        raise NotImplementedError("calc_gradient supports a single target")
    target = targets[0]
    block = target.block
    input_names = {v.name for v in inputs}
    # run append_backward but collect grads of arbitrary inputs
    append_backward(target, parameter_list=None, no_grad_set=no_grad_set)
    grads = []
    for v in inputs:
        g = grad_var_name(v.name)
        grads.append(block.vars.get(g))
    return grads
