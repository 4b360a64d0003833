"""Sequence (LoD) operators on the padded-batch representation.

Counterpart of ``paddle_tpu/ops/sequence.py``, op for op (parity:
reference operators/sequence_*_op.cc, lstm_op.cc, gru_op.cc).  A ragged
batch is a padded dense [N, T, D] tensor plus a device-side int32
length vector '<name>@LEN' in the env (``core/executor_impl.
_prepare_lod_feeds``); nested levels add '<name>@LEN@j'.  Every op is
a static-shape masked computation on the device: masks, reversal
indices, counts and the LAST index come from the '@LEN' tensor, and
nothing reads a length on the host, so a prepared step captures as one
CUDA graph.  Only T, the feed's padded bucket, comes from the host.

The recurrences (``lstm``, ``gru``, ``lstmp``) are the JAX package's
``lax.scan`` written as a Python loop over the padded T: one step's ops
a time step, each masked, so a short sequence keeps its state past its
end.  Their gradients come from ``lowering.generic_grad_lower``
(autograd through the loop).  ``edit_distance``'s DP is two such loops.

Dtypes follow jnp's promotion: an f32 operand promotes a bf16 one
(``_mm`` casts both operands of a product, which torch would refuse),
a Python scalar keeps the tensor's dtype, so under bf16 AMP a bf16
``Input`` and an f32 ``Bias`` run the LSTM's recurrence in f32, as in
the JAX package.  ``MAX`` pooling takes ``amax``, whose gradient
splits among tied maxima as ``jnp.max``'s does.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
    "": lambda x: x,
}
# gru_unit's integer activation codes (reference gru_unit_op.h)
_ACT_CODES = {1: "sigmoid", 2: "tanh", 0: "identity", 3: "relu"}


def _act(name):
    return _ACTS[name]


def _promote(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _mm(a, b):
    """``a @ b`` in the dtype jnp promotes the two to."""
    a, b = _promote(a, b)
    return a @ b


def _lens_of(ctx, op, slot):
    if op is None:
        return None
    names = op.inputs.get(slot) or []
    if names and names[0]:
        return ctx.seq_len_of(names[0])
    return None


def _arange(t, like):
    return torch.arange(t, device=like.device)


def _mask(lens, n, t, dtype=torch.float32, device=None):
    """[N, T] 1/0 validity mask; all ones when lens is None."""
    if lens is None:
        return torch.ones((n, t), dtype=dtype, device=device)
    return (_arange(t, lens)[None, :] < lens[:, None]).to(dtype)


def _reverse_time(x, lens):
    """Reverse each sequence within its own length (padding stays put):
    the reference's is_reverse on packed batches."""
    if lens is None:
        return torch.flip(x, [1])
    t = x.shape[1]
    tt = _arange(t, x)[None, :]
    ln = lens[:, None].to(torch.int64)
    idx = torch.where(tt < ln, ln - 1 - tt, tt)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Recurrent ops
# ---------------------------------------------------------------------------

def _lstm_scan(x, w, b, lens, attrs, h0=None, c0=None, w_proj=None,
               proj_act=None):
    """The masked LSTM recurrence of ``lstm`` and ``lstmp``.

    With ``w_proj`` the recurrent state is the projection
    r = proj_act(h @ w_proj) (reference lstmp_op.cc) and the sequence
    output is [N, T, P]; otherwise it is the hidden state [N, T, H]."""
    n, t, h4 = x.shape
    h = h4 // 4
    rev = bool(attrs.get("is_reverse", False))
    peep = bool(attrs.get("use_peepholes", True)) and b is not None \
        and b.shape[-1] == 7 * h
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cell_act = _act(attrs.get("cell_activation", "tanh"))
    cand_act = _act(attrs.get("candidate_activation", "tanh"))

    if b is not None:
        x = x + b[..., : 4 * h].reshape(1, 1, 4 * h)
    if peep:
        ck_i, ck_f, ck_o = torch.split(b[0, 4 * h:], h)
    if rev:
        x = _reverse_time(x, lens)

    mask = _mask(lens, n, t, x.dtype, x.device)
    r_dim = w_proj.shape[1] if w_proj is not None else h
    r_prev = h0 if h0 is not None else torch.zeros(
        (n, r_dim), dtype=x.dtype, device=x.device)
    c_prev = c0 if c0 is not None else torch.zeros(
        (n, h), dtype=x.dtype, device=x.device)

    rs, cs = [], []
    for xt, mt in zip(x.unbind(1), mask.unbind(1)):
        g = xt + _mm(r_prev, w)
        cand, gi, gf, go = g.chunk(4, -1)
        if peep:
            gi = gi + c_prev * ck_i
            gf = gf + c_prev * ck_f
        i = gate_act(gi)
        f = gate_act(gf)
        c = f * c_prev + i * cand_act(cand)
        if peep:
            go = go + c * ck_o
        o = gate_act(go)
        hh = o * cell_act(c)
        r = proj_act(_mm(hh, w_proj)) if w_proj is not None else hh
        mt = mt[:, None]
        c = mt * c + (1 - mt) * c_prev
        r_masked = mt * r
        r_prev = r_masked + (1 - mt) * r_prev
        c_prev = c
        rs.append(r_masked)
        cs.append(c)
    out = torch.stack(rs, 1)
    cell = torch.stack(cs, 1)
    if rev:
        out = _reverse_time(out, lens)
        cell = _reverse_time(cell, lens)
    return out, cell


def _lstm_dtype(ins):
    """The dtype jnp gives a recurrence's outputs: its operands'
    promotion."""
    dt = ins["Input"].dtype
    for slot in ("Bias", "Weight", "H0", "C0", "ProjWeight"):
        if ins.get(slot) is not None:
            dt = torch.promote_types(dt, ins.get(slot).dtype)
    return dt


def _lstm_infer(ins, attrs, op):
    """Build-time shapes without looping over T on meta tensors."""
    n, t, h4 = ins["Input"].shape
    dt = _lstm_dtype(ins)
    return {"Hidden": _meta((n, t, h4 // 4), dt),
            "Cell": _meta((n, t, h4 // 4), dt)}


@register_op("lstm", no_vjp_outputs=("BatchGate", "BatchCellPreAct"),
             infer_shape=_lstm_infer)
def _lstm(ctx, ins, attrs, op=None):
    """LSTM over a padded batch (reference lstm_op.cc:180 equations).

    Input [N, T, 4H] (pre-projected x), Weight [H, 4H] with gate columns
    ordered [c~, i, f, o] (reference math/detail/lstm_kernel.h memory
    layout), Bias [1, 4H] or [1, 7H] with the peephole vectors checkI /
    checkF / checkO appended (use_peepholes).  Outputs Hidden / Cell
    [N, T, H]."""
    hidden, cell = _lstm_scan(
        ins["Input"], ins["Weight"], ins.get("Bias"),
        _lens_of(ctx, op, "Input"), attrs,
        h0=ins.get("H0"), c0=ins.get("C0"))
    return {"Hidden": hidden, "Cell": cell}


def _gru_infer(ins, attrs, op):
    n, t, d3 = ins["Input"].shape
    return {"Hidden": _meta((n, t, d3 // 3), _lstm_dtype(ins))}


@register_op("gru", infer_shape=_gru_infer)
def _gru(ctx, ins, attrs, op=None):
    """GRU over a padded batch (reference gru_op.cc:129-142):
    u = act_gate(x_u + h W_u), r = act_gate(x_r + h W_r),
    h~ = act(x_c + (r * h) W_c), h_t = (1 - u) * h_{t-1} + u * h~.
    Input [N, T, 3D]; Weight [D, 3D] = [W_u | W_r | W_c]; Bias [1, 3D]."""
    x = ins["Input"]
    w = ins["Weight"]
    b = ins.get("Bias")
    h0 = ins.get("H0")
    lens = _lens_of(ctx, op, "Input")
    n, t, d3 = x.shape
    d = d3 // 3
    rev = bool(attrs.get("is_reverse", False))
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    act = _act(attrs.get("activation", "tanh"))
    wu, wr, wc = w[:, :d], w[:, d: 2 * d], w[:, 2 * d:]

    if b is not None:
        x = x + b.reshape(1, 1, d3)
    if rev:
        x = _reverse_time(x, lens)
    mask = _mask(lens, n, t, x.dtype, x.device)
    h_prev = h0 if h0 is not None else torch.zeros(
        (n, d), dtype=x.dtype, device=x.device)

    hs = []
    for xt, mt in zip(x.unbind(1), mask.unbind(1)):
        xu, xr, xc = xt.chunk(3, -1)
        u = gate_act(xu + _mm(h_prev, wu))
        r = gate_act(xr + _mm(h_prev, wr))
        cand = act(xc + _mm(r * h_prev, wc))
        hh = (1 - u) * h_prev + u * cand
        mt = mt[:, None]
        h_prev = mt * hh + (1 - mt) * h_prev
        hs.append(mt * hh)
    hidden = torch.stack(hs, 1)
    if rev:
        hidden = _reverse_time(hidden, lens)
    return {"Hidden": hidden}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs, op=None):
    """Single-step LSTM cell (reference lstm_unit_op.cc): X [N, 4H] pre-
    activation gates (order [c~, i, f, o]), C_prev [N, H]."""
    x, c_prev = ins["X"], ins["C_prev"]
    forget_bias = float(attrs.get("forget_bias", 0.0))
    cand, gi, gf, go = x.chunk(4, -1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf + forget_bias)
    o = torch.sigmoid(go)
    c = f * c_prev + i * torch.tanh(cand)
    return {"C": c, "H": o * torch.tanh(c)}


def _unit_act(attrs, key, default_code, default_name):
    v = attrs.get(key, default_code)
    if isinstance(v, int):
        return _act(_ACT_CODES.get(v, default_name))
    return _act(v)


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs, op=None):
    """Single-step GRU cell (reference gru_unit_op.cc)."""
    x = ins["Input"]             # [N, 3D]
    h_prev = ins["HiddenPrev"]   # [N, D]
    w = ins["Weight"]            # [D, 3D]
    b = ins.get("Bias")
    d = h_prev.shape[-1]
    if b is not None:
        x = x + b.reshape(1, -1)
    gate_act = _unit_act(attrs, "gate_activation", 1, "sigmoid")
    act = _unit_act(attrs, "activation", 2, "tanh")
    xu, xr, xc = x.chunk(3, -1)
    u = gate_act(xu + _mm(h_prev, w[:, :d]))
    r = gate_act(xr + _mm(h_prev, w[:, d: 2 * d]))
    cand = act(xc + _mm(r * h_prev, w[:, 2 * d:]))
    gate = torch.cat(_promote(u, r, cand), -1)
    hidden = (1 - u) * h_prev + u * cand
    return {"Gate": gate, "ResetHiddenPrev": r * h_prev, "Hidden": hidden}


# ---------------------------------------------------------------------------
# Sequence manipulation ops
# ---------------------------------------------------------------------------

def _inner_lens_of(ctx, op, slot):
    """The deepest nested lengths of a level >= 2 LoD input: the largest
    m with '<name>@LEN@m' present (``_prepare_lod_feeds`` makes one a
    level), returned as (lens [N, S1, .., Sm], m); None for dense and
    level-1 inputs."""
    if op is None:
        return None
    names = op.inputs.get(slot) or []
    if not (names and names[0]):
        return None
    name, m = names[0], 0
    while (name + "@LEN@%d" % (m + 1)) in ctx.env:
        m += 1
    if m == 0:
        return None
    return ctx.env[name + "@LEN@%d" % m], m


def _fold_level2(x, inner):
    """[N, S1, .., Sm, W, ...] + [N, S1, .., Sm] ->
    ([N*S1*..*Sm, W, ...], [M], lead): nested data folded so a level-1
    op body works at the finest level (reference sequence ops always
    operate at the finest LoD level, lod_tensor.h:58-110); any depth
    folds, ``inner.dim()`` leading dims collapse."""
    lead = tuple(x.shape[:inner.dim()])
    m = int(np.prod(lead))
    return (x.reshape((m,) + tuple(x.shape[inner.dim():])),
            inner.reshape(m), lead)


def _copy_nested_lens(ctx, op, oname, upto):
    """Carry '@LEN@1' .. '@LEN@upto' from the X input to an output
    (shape-preserving ops keep every level; pooling keeps upto - 1)."""
    names = op.inputs.get("X") or []
    if not (names and names[0]):
        return
    src = names[0]
    for j in range(1, upto + 1):
        v = ctx.env.get(src + "@LEN@%d" % j)
        if v is not None:
            ctx.env[oname + "@LEN@%d" % j] = v


def _pool_core(x, lens, ptype):
    """[N, T, ...] -> {Out: [N, ...], MaxIndex} masked by lens."""
    n, t = x.shape[:2]
    tail = (1,) * (x.dim() - 2)
    mask = _mask(lens, n, t, x.dtype, x.device)
    m = mask.reshape(mask.shape + tail)
    counts = (mask.sum(1).reshape((n,) + tail) if lens is not None
              else torch.full((n,) + tail, t, dtype=x.dtype,
                              device=x.device))
    outs = {}
    if ptype == "SUM":
        out = (x * m).sum(1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(1) / torch.clamp(counts, min=1)
    elif ptype == "SQRT":
        out = (x * m).sum(1) / torch.sqrt(torch.clamp(counts, min=1))
    elif ptype == "MAX":
        masked = torch.where(m > 0, x, torch.finfo(x.dtype).min)
        # an empty (all-padding) sequence pools to 0, not -inf: it only
        # exists as level-2 outer padding and is masked downstream
        out = torch.where(counts > 0, masked.amax(1), 0)
        outs["MaxIndex"] = masked.argmax(1).to(torch.int32)
    elif ptype == "LAST":
        idx = (torch.clamp(lens - 1, min=0) if lens is not None
               else torch.full((n,), t - 1, device=x.device))
        idx = idx.to(torch.int64).reshape((n, 1) + tail).expand(
            (n, 1) + tuple(x.shape[2:]))
        out = torch.gather(x, 1, idx)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    outs["Out"] = out
    if "MaxIndex" not in outs:  # the slot is always declared by the layer
        outs["MaxIndex"] = torch.zeros((n,) + tuple(x.shape[2:]),
                                       dtype=torch.int32, device=x.device)
    return outs


@register_op("sequence_pool", seq_aware=True,
             no_vjp_outputs=("MaxIndex",))
def _sequence_pool(ctx, ins, attrs, op=None):
    """Pool each sequence to one vector (reference sequence_pool_op.cc):
    SUM / AVERAGE / SQRT / MAX / LAST / FIRST.  [N, T, D] -> [N, D]; a
    level-2 input [N, S, W, D] pools each inner sub-sequence (the finest
    level) -> [N, S, D], the outer lengths carried to the output."""
    x = ins["X"]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    nested = _inner_lens_of(ctx, op, "X")
    if nested is not None:
        inner, depth = nested
        xf, lf, lead = _fold_level2(x, inner)
        outs = _pool_core(xf, lf, ptype)
        outs = {k: v.reshape(lead + tuple(v.shape[1:]))
                for k, v in outs.items()}
        if op is not None and op.outputs.get("Out"):
            # pooling consumes the finest level: a level-k input gives a
            # level-(k - 1) output
            oname = op.outputs["Out"][0]
            outer = _lens_of(ctx, op, "X")
            if outer is not None:
                ctx.set_seq_len(oname, outer)
            _copy_nested_lens(ctx, op, oname, depth - 1)
        return outs
    return _pool_core(x, _lens_of(ctx, op, "X"), ptype)


def _softmax_core(x, lens):
    n, t = x.shape[:2]
    mask = _mask(lens, n, t, x.dtype, x.device).reshape(
        (n, t) + (1,) * (x.dim() - 2))
    mx = torch.where(mask > 0, x, torch.finfo(x.dtype).min).amax(
        1, keepdim=True)
    # an all-padding (length-0) sequence has mx = finfo.min, where
    # exp(x - mx) overflows to inf.  The JAX package masks the exp's
    # output alone, so its gradient there is 0 * inf = NaN (a level-2
    # batch's empty sub-sequences); the exp's input is masked too here,
    # so the padding's gradient is 0 and the values are the same
    valid = mask > 0
    e = torch.where(valid, torch.exp(torch.where(valid, x - mx, 0)), 0)
    return e / torch.clamp(e.sum(1, keepdim=True), min=1e-20)


@register_op("sequence_softmax", seq_aware=True)
def _sequence_softmax(ctx, ins, attrs, op=None):
    """Softmax within each sequence over the time axis, masked; a
    level-2 input normalizes within each inner sub-sequence."""
    x = ins["X"]
    nested = _inner_lens_of(ctx, op, "X")
    if nested is not None:
        inner, depth = nested
        xf, lf, _ = _fold_level2(x, inner)
        out = _softmax_core(xf, lf).reshape(x.shape)
        if op is not None and op.outputs.get("Out"):
            oname = op.outputs["Out"][0]
            outer = _lens_of(ctx, op, "X")
            if outer is not None:   # shape-preserving: every level carries
                ctx.set_seq_len(oname, outer)
            _copy_nested_lens(ctx, op, oname, depth)
        return {"Out": out}
    lens = _lens_of(ctx, op, "X")
    out = _softmax_core(x, lens)
    if op is not None and op.outputs.get("Out") and lens is not None:
        ctx.set_seq_len(op.outputs["Out"][0], lens)
    return {"Out": out}


@register_op("sequence_expand", seq_aware=True)
def _sequence_expand(ctx, ins, attrs, op=None):
    """Broadcast per-sequence vectors over the time steps of a reference
    ragged batch (reference sequence_expand_op.cc): X [N, D] + Y
    [N, T, ..] -> [N, T, D] masked by Y's lengths."""
    x, y = ins["X"], ins["Y"]
    lens = _lens_of(ctx, op, "Y")
    n, t = x.shape[0], y.shape[1]
    out = x[:, None].expand((n, t) + tuple(x.shape[1:]))
    m = _mask(lens, n, t, x.dtype, x.device).reshape(
        (n, t) + (1,) * (x.dim() - 1))
    out = out * m
    if op is not None and op.outputs.get("Out") and lens is not None:
        ctx.set_seq_len(op.outputs["Out"][0], lens)
    return {"Out": out}


def _shift_valid(t, shift, like):
    """Validity of positions after shifting by ``shift`` (zero padding
    outside [0, T))."""
    src = _arange(t, like)[None, :, None] + shift
    return ((src >= 0) & (src < t)).to(like.dtype)


def _seq_conv_core(x, lens, filt, ctx_len, ctx_start):
    n, t, _ = x.shape
    m = _mask(lens, n, t, x.dtype, x.device)[..., None]
    xm = x * m
    cols = [torch.roll(xm, -(ctx_start + k), 1)
            * _shift_valid(t, ctx_start + k, x) for k in range(ctx_len)]
    col = torch.cat(cols, -1)                     # [N, T, ctx * D]
    return _mm(col, filt) * m


@register_op("sequence_conv", seq_aware=True)
def _sequence_conv(ctx, ins, attrs, op=None):
    """Context-window convolution over time (reference
    sequence_conv_op.cc): X [N, T, D], Filter [ctx_len * D, F].  A
    level-2 input convolves within each inner sub-sequence: the window
    never crosses a sub-sequence boundary."""
    x = ins["X"]
    filt = ins["Filter"]
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -(ctx_len // 2)))
    nested = _inner_lens_of(ctx, op, "X")
    if nested is not None:
        inner, depth = nested
        xf, lf, lead = _fold_level2(x, inner)
        out = _seq_conv_core(xf, lf, filt, ctx_len, ctx_start)
        out = out.reshape(lead + tuple(out.shape[1:]))
        if op is not None and op.outputs.get("Out"):
            oname = op.outputs["Out"][0]
            outer = _lens_of(ctx, op, "X")
            if outer is not None:
                ctx.set_seq_len(oname, outer)
            _copy_nested_lens(ctx, op, oname, depth)
        return {"Out": out}
    lens = _lens_of(ctx, op, "X")
    out = _seq_conv_core(x, lens, filt, ctx_len, ctx_start)
    if op is not None and op.outputs.get("Out") and lens is not None:
        ctx.set_seq_len(op.outputs["Out"][0], lens)
    return {"Out": out}


def _erase_infer(ins, attrs, op):
    """The JAX package's desc records int64 tokens as int32 (its int64
    narrows without x64); the lowering keeps them int64."""
    x = ins["X"]
    return {"Out": _meta(tuple(x.shape), torch.int32
                         if x.dtype == torch.int64 else x.dtype)}


@register_op("sequence_erase", seq_aware=True, infer_shape=_erase_infer)
def _sequence_erase(ctx, ins, attrs, op=None):
    """Remove the listed tokens and compact each sequence left
    (reference sequence_erase_op.cc).  X [N, T] (or [N, T, 1]) int
    tokens."""
    x = ins["X"]
    lens = _lens_of(ctx, op, "X")
    tokens = attrs.get("tokens", [])
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    ids = x[..., 0] if squeeze else x
    n, t = ids.shape
    keep = _mask(lens, n, t, torch.bool, x.device)
    for tok in tokens:
        keep = keep & (ids != tok)
    # a stable left compaction: sort by (dropped, position)
    key = torch.where(keep, 0, 1) * t + _arange(t, x)[None, :]
    order = torch.argsort(key, dim=1, stable=True)
    gathered = torch.gather(ids, 1, order)
    new_lens = keep.sum(1).to(torch.int32)
    pos_ok = _arange(t, x)[None, :] < new_lens[:, None]
    out = torch.where(pos_ok, gathered, 0)
    if squeeze:
        out = out[..., None]
    if op is not None and op.outputs.get("Out"):
        ctx.set_seq_len(op.outputs["Out"][0], new_lens)
    return {"Out": out}


@register_op("seq_cross_attention", seq_aware=True)
def _seq_cross_attention(ctx, ins, attrs, op=None):
    """Dot-product cross attention with key-side length masking: the
    batched static-shape form of the reference's per-step attention in a
    DynamicRNN (book machine_translation: sequence_expand + sequence_
    softmax over encoder states).  Q [N, Tq, D], K / V [N, Tk, D]."""
    q, k, v = _promote(ins["Q"], ins["K"], ins["V"])
    klens = _lens_of(ctx, op, "K")
    scale = float(attrs.get("scale", 0.0)) or q.shape[-1] ** -0.5
    s = torch.einsum("nqd,nkd->nqk", q, k) * scale
    if klens is not None:
        mask = _arange(k.shape[1], k)[None, None, :] < klens[:, None, None]
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    w = torch.softmax(s, -1)
    out = torch.einsum("nqk,nkd->nqd", w, v)
    if op is not None and op.outputs.get("Out"):
        qlens = _lens_of(ctx, op, "Q")
        if qlens is not None:
            ctx.set_seq_len(op.outputs["Out"][0], qlens)
    return {"Out": out}


@register_op("lod_reset", seq_aware=True)
def _lod_reset(ctx, ins, attrs, op=None):
    """Reassign sequence lengths from the attr target_lod (offsets) or a
    second input (reference lod_reset_op.cc).  The attr form copies its
    lengths from the host at every run: a card's prepared step refuses
    it (``executor_impl.Uncapturable``)."""
    x = ins["X"]
    y = ins.get("Y")
    if y is not None:
        lens = y.to(torch.int32)
    else:
        offs = list(attrs.get("target_lod", []))
        lens = torch.tensor(np.diff(np.asarray(offs, np.int64)),
                            dtype=torch.int32, device=x.device) \
            if offs else None
    if op is not None and op.outputs.get("Out") and lens is not None:
        ctx.set_seq_len(op.outputs["Out"][0], lens)
    return {"Out": x}


def _edit_distance_infer(ins, attrs, op):
    n = ins["Hyps"].shape[0]
    return {"Out": _meta((n, 1), torch.float32),
            "SequenceNum": _meta((1,), torch.int32)}


@register_op("edit_distance", grad_maker=None, seq_aware=True,
             infer_shape=_edit_distance_infer)
def _edit_distance(ctx, ins, attrs, op=None):
    """Levenshtein distance per (hypothesis, reference) pair by a DP over
    the padded lengths (reference edit_distance_op.cc).  Hyps [N, T1],
    Refs [N, T2] int tokens with '@LEN' lengths.  SequenceNum is int32,
    the JAX package's dtype (its int64 narrows without x64)."""
    hyp, ref = ins["Hyps"], ins["Refs"]
    hlens = _lens_of(ctx, op, "Hyps")
    rlens = _lens_of(ctx, op, "Refs")
    norm = bool(attrs.get("normalized", False))
    h = hyp[..., 0] if hyp.dim() == 3 else hyp
    r = ref[..., 0] if ref.dim() == 3 else ref
    n, t1 = h.shape
    t2 = r.shape[1]
    dev = h.device
    if hlens is None:
        hlens = torch.full((n,), t1, dtype=torch.int32, device=dev)
    if rlens is None:
        rlens = torch.full((n,), t2, dtype=torch.int32, device=dev)
    f32 = torch.float32
    # DP rows over the hypothesis tokens; rows past a length stay put
    row = torch.arange(t2 + 1, dtype=f32, device=dev)[None].expand(
        n, t2 + 1)
    row = torch.minimum(row, rlens[:, None].to(f32))
    for i in range(t1):
        sub = row[:, :-1] + (h[:, i][:, None] != r).to(f32)
        first = row[:, 0] + 1.0
        prev, cols = first, []
        for j in range(t2):
            prev = torch.minimum(torch.minimum(row[:, j + 1] + 1.0,
                                               prev + 1.0), sub[:, j])
            cols.append(prev)
        new = torch.cat([first[:, None], torch.stack(cols, 1)], 1)
        row = torch.where((hlens > i)[:, None], new, row)
    dist = torch.gather(row, 1, rlens[:, None].to(torch.int64))
    if norm:
        dist = dist / torch.clamp(rlens[:, None].to(f32), min=1.0)
    return {"Out": dist.to(f32),
            "SequenceNum": torch.full((1,), n, dtype=torch.int32,
                                      device=dev)}


@register_op("sequence_concat", seq_aware=True)
def _sequence_concat(ctx, ins, attrs, op=None):
    """Per-row concatenation along time (reference
    sequence_concat_op.cc): row n of the output is the valid tokens of
    every input's row n back to back; '@LEN' = the sum of the inputs'
    lengths.  Invalid tokens land in one scratch column past the end,
    which is cut off (where XLA drops an out-of-bounds update)."""
    xs = [v for v in ins.list("X") if v is not None]
    n = xs[0].shape[0]
    dev = xs[0].device
    t_out = sum(x.shape[1] for x in xs)
    names = (op.inputs.get("X") or []) if op is not None else []
    lens = []
    for i, x in enumerate(xs):
        ln = ctx.seq_len_of(names[i]) if i < len(names) and names[i] \
            else None
        lens.append(ln.to(torch.int32) if ln is not None
                    else torch.full((n,), x.shape[1], dtype=torch.int32,
                                    device=dev))
    out = torch.zeros((n, t_out + 1) + tuple(xs[0].shape[2:]),
                      dtype=xs[0].dtype, device=dev)
    offset = torch.zeros((n,), dtype=torch.int32, device=dev)
    for x, ln in zip(xs, lens):
        ti = x.shape[1]
        pos = _arange(ti, x)[None, :]
        col = torch.where(pos < ln[:, None], offset[:, None] + pos, t_out)
        rows = _arange(n, x)[:, None].expand(n, ti)
        out = out.index_put((rows, col.to(torch.int64)),
                            x.to(out.dtype))
        offset = offset + ln
    if op is not None:
        for nm in (op.outputs.get("Out") or []):
            if nm:
                ctx.set_seq_len(nm, offset)
    return {"Out": out[:, :t_out]}


@register_op("sequence_reshape", seq_aware=True)
def _sequence_reshape(ctx, ins, attrs, op=None):
    """Change the token width (reference sequence_reshape_op.cc):
    [N, T, D] -> [N, T * D / nd, nd]; row lengths scale by D / nd.
    Valid tokens lead each row of the padded layout, so a flat reshape
    is exact."""
    x = ins["X"]
    nd = int(attrs["new_dim"])
    n, t, d = x.shape
    assert (t * d) % nd == 0, "new_dim must divide T*D"
    out = x.reshape(n, t * d // nd, nd)
    lens = _lens_of(ctx, op, "X")
    if lens is not None and op is not None:
        for nm in (op.outputs.get("Out") or []):
            if nm:
                ctx.set_seq_len(nm, (lens * d) // nd)
    return {"Out": out}


@register_op("sequence_slice", seq_aware=True)
def _sequence_slice(ctx, ins, attrs, op=None):
    """Per-sequence [offset, offset + length) slice, left-aligned
    (reference sequence_slice_op.cc); '@LEN' = Length."""
    x = ins["X"]
    off = ins["Offset"].reshape(-1).to(torch.int64)
    length = ins["Length"].reshape(-1).to(torch.int32)
    n, t = x.shape[0], x.shape[1]
    pos = _arange(t, x)[None, :]
    src = torch.clamp(pos + off[:, None], 0, t - 1)
    rows = _arange(n, x)[:, None]
    out = x[rows, src]
    keep = pos < length[:, None]
    out = torch.where(keep.reshape(keep.shape + (1,) * (x.dim() - 2)),
                      out, 0)
    if op is not None:
        for nm in (op.outputs.get("Out") or []):
            if nm:
                ctx.set_seq_len(nm, length)
    return {"Out": out}


def _lstmp_infer(ins, attrs, op):
    x = ins["Input"]
    n, t, h4 = x.shape
    dt = _lstm_dtype(ins)
    return {"Projection": _meta((n, t, ins["ProjWeight"].shape[1]), dt),
            "Cell": _meta((n, t, h4 // 4), dt)}


@register_op("lstmp", infer_shape=_lstmp_infer)
def _lstmp(ctx, ins, attrs, op=None):
    """LSTM with a recurrent projection (reference lstmp_op.cc): the
    recurrence feeds the projection r = proj_act(h @ ProjWeight), so
    Weight is [P, 4H] and the sequence output is the projection
    [N, T, P]."""
    proj, cell = _lstm_scan(
        ins["Input"], ins["Weight"], ins.get("Bias"),
        _lens_of(ctx, op, "Input"), attrs,
        h0=ins.get("H0"), c0=ins.get("C0"),
        w_proj=ins["ProjWeight"],
        proj_act=_act(attrs.get("proj_activation", "tanh")))
    return {"Projection": proj, "Cell": cell}


@register_op("kmax_seq_score", grad_maker=None, seq_aware=True)
def _kmax_seq_score(ctx, ins, attrs, op=None):
    """Top-k score positions within each sequence (reference
    gserver/layers/KmaxSeqScoreLayer.cpp via kmax_seq_score_layer:7191):
    X [N, T, 1] ragged scores; Out [N, k] int32 indices into the
    sequence (the slots past a short sequence's k are -1)."""
    x = ins["X"]
    if x.dim() == 3:
        x = x[..., 0]
    k = int(attrs.get("beam_size", 1))
    n, t = x.shape
    lens = _lens_of(ctx, op, "X")
    if lens is None:
        lens = torch.full((n,), t, dtype=torch.int32, device=x.device)
    valid = _arange(t, x)[None, :] < lens[:, None]
    masked = torch.where(valid, x.to(torch.float32), -float("inf"))
    kk = min(k, t)
    idx = torch.topk(masked, kk, dim=1).indices            # [N, kk]
    in_range = _arange(kk, x)[None, :] < \
        torch.clamp(lens, max=kk)[:, None]
    idx = torch.where(in_range, idx, -1).to(torch.int32)
    if kk < k:
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return {"Out": idx}


@register_op("sub_nested_seq", seq_aware=True)
def _sub_nested_seq(ctx, ins, attrs, op=None):
    """Select inner sub-sequences of a level-2 input by per-sample index
    lists (reference gserver/layers/SubNestedSequenceLayer.cpp via
    sub_nested_seq_layer:7045): X level-2 [N, S, W, ...] with inner
    lengths, SelectedIndices a ragged int list per sample; Out is the
    level-2 sequence keeping only the selected inner rows, in the given
    order."""
    x = ins["X"]
    sel = ins["SelectedIndices"]
    if sel.dim() == 3:
        sel = sel[..., 0]
    sel = sel.to(torch.int64)
    nested = _inner_lens_of(ctx, op, "X")
    if nested is None:
        raise ValueError(
            "sub_nested_seq requires a level-2 X (a level-1 input has "
            "no sub-sequences to select; use sequence_slice)")
    inner, depth = nested
    if depth != 1:
        raise NotImplementedError(
            "sub_nested_seq: only level-2 inputs are supported "
            "(level-%d given)" % (depth + 1))
    n, s = x.shape[:2]
    k = sel.shape[1]
    tail = (1,) * (x.dim() - 2)
    sel_lens = _lens_of(ctx, op, "SelectedIndices")
    if sel_lens is None:
        sel_lens = torch.full((n,), k, dtype=torch.int32, device=x.device)
    kvalid = _arange(k, x)[None, :] < sel_lens[:, None]
    idx = torch.where(kvalid, torch.clamp(sel, 0, s - 1), 0)
    gidx = idx.reshape((n, k) + tail).expand((n, k) + tuple(x.shape[2:]))
    out = torch.gather(x, 1, gidx)
    out = torch.where(kvalid.reshape((n, k) + tail), out, 0)
    new_inner = torch.where(kvalid, torch.gather(inner, 1, idx), 0)
    if op is not None and op.outputs.get("Out"):
        oname = op.outputs["Out"][0]
        ctx.set_seq_len(oname, sel_lens)
        ctx.env[oname + "@LEN@1"] = new_inner
    return {"Out": out}
