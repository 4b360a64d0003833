"""Structured-prediction ops: linear-chain CRF, Viterbi decoding, CTC
loss, CTC alignment, chunk evaluation.

Counterpart of ``paddle_tpu/ops/crf_ctc.py``, op for op (parity:
reference operators/linear_chain_crf_op.{cc,h}, crf_decoding_op.cc,
warpctc_op.cc, ctc_align_op.cc, chunk_eval_op.cc).

All ops run on the padded [N, T, ...] + '@LEN' representation
(``ops/sequence.py``).  The JAX package's ``lax.scan`` recursions are
Python loops over the padded T here, one masked step a time step; the
masks and the last index come from the device '@LEN' tensor, and
nothing reads a length on the host, so a prepared step captures as one
CUDA graph a padded bucket.  The gradients of ``linear_chain_crf`` and
``warpctc`` come from ``lowering.generic_grad_lower`` (autograd through
the loop), as the reference's come from ``jax.vjp``.

Ties follow jax: an argmax takes the first maximum (``_first_argmax``,
on either device) and ``ctc_align`` compacts with a stable sort.
``warpctc``'s log-space sums use ``logaddexp`` with jax's formula and
gradient (``exp(x - out)``), so two ``NEG`` operands pass a cotangent
of 1 each, as in the reference, where torch's would pass 0.5.

``chunk_eval`` is a host op (``ops/io_ops._host``): a metric over the
tags read to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.executor_impl import fetches_to_host
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.io_ops import _host, _install
from paddle_tpu_torch.ops.sequence import _lens_of

NEG = -1e30


def _lens_or_full(ctx, op, slot, n, t, device):
    """The device int32 '@LEN' of input ``slot``, or [n] of ``t``."""
    lens = _lens_of(ctx, op, slot)
    if lens is None:
        return torch.full((n,), t, dtype=torch.int32, device=device)
    return lens.to(torch.int32)


def _steps(t, device):
    return torch.arange(t, device=device)


def _first_argmax(x, dim):
    """(max, index of its first occurrence) along ``dim``, as jnp.max and
    jnp.argmax: the same tie rule on the CPU and the card."""
    best = torch.amax(x, dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    idx = _steps(x.shape[dim], x.device).reshape(shape)
    first = torch.where(x == best, idx, x.shape[dim]).amin(dim=dim)
    return best.squeeze(dim), first


def _label_2d(label):
    return (label[..., 0] if label.dim() == 3 else label).long()


# ---------------------------------------------------------------------------
# linear_chain_crf / crf_decoding
# ---------------------------------------------------------------------------

@register_op("linear_chain_crf", seq_aware=True)
def _linear_chain_crf(ctx, ins, attrs, op=None):
    """Emission [N,T,K]; Transition [K+2,K] (row 0 start, row 1 stop,
    rows 2.. pairwise [K,K]); Label [N,T,1] or [N,T] int.
    LogLikelihood [N,1] = logZ - gold score (the reference's negative
    log-likelihood)."""
    em = ins["Emission"]
    w = ins["Transition"]
    label = _label_2d(ins["Label"])
    n, t, k = em.shape
    lens = _lens_or_full(ctx, op, "Emission", n, t, em.device)
    start, stop, trans = w[0], w[1], w[2:]

    emf = em.float()
    valid = _steps(t, em.device)[None, :] < lens[:, None]     # [N,T]

    # logZ by the forward algorithm (log space)
    alpha = start[None, :] + emf[:, 0, :]                      # [N,K]
    for s in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + emf[:, s, :]
        alpha = torch.where(valid[:, s, None], nxt, alpha)
    logz = torch.logsumexp(alpha + stop[None, :], dim=1)      # [N]

    # gold path score
    zero = torch.zeros((), dtype=emf.dtype, device=em.device)
    em_lab = torch.gather(emf, 2, label[:, :, None])[..., 0]   # [N,T]
    em_score = torch.where(valid, em_lab, zero).sum(dim=1)
    pair = trans[label[:, :-1], label[:, 1:]]                  # [N,T-1]
    trans_score = torch.where(valid[:, 1:], pair, zero).sum(dim=1)
    last_idx = torch.clamp(lens.long() - 1, 0, t - 1)
    last_lab = torch.gather(label, 1, last_idx[:, None])[:, 0]
    gold = em_score + trans_score + start[label[:, 0]] + stop[last_lab]

    nll = (logz - gold) * (lens > 0)     # an empty sequence costs 0
    return {"LogLikelihood": nll[:, None].to(em.dtype)}


@register_op("crf_decoding", grad_maker=None, seq_aware=True)
def _crf_decoding(ctx, ins, attrs, op=None):
    """Viterbi decode (reference crf_decoding_op.h).  With Label given,
    emits the per-token correctness mask instead of the raw path (the
    reference behaviour the metrics use)."""
    em = ins["Emission"].float()
    w = ins["Transition"]
    n, t, k = em.shape
    lens = _lens_or_full(ctx, op, "Emission", n, t, em.device)
    start, stop, trans = w[0], w[1], w[2:]
    valid = _steps(t, em.device)[None, :] < lens[:, None]

    delta = start[None, :] + em[:, 0, :]
    back = []                                 # back[s - 1]: [N,K] at s
    for s in range(1, t):
        best, arg = _first_argmax(delta[:, :, None] + trans[None, :, :], 1)
        back.append(arg)
        delta = torch.where(valid[:, s, None], best + em[:, s, :], delta)

    _, state = _first_argmax(delta + stop[None, :], 1)          # [N]

    # backtrack from each sequence's last step; frozen steps (past the
    # sequence) pass the state through unchanged
    path = [None] * t
    for s in range(t - 1, 0, -1):
        path[s] = state
        prev = torch.gather(back[s - 1], 1, state[:, None])[:, 0]
        state = torch.where(valid[:, s], prev, state)
    path[0] = state
    path = torch.stack(path, dim=1)                           # [N,T]
    path = torch.where(valid, path, torch.zeros_like(path))

    label = ins.get("Label")
    if label is not None:
        out = (path == _label_2d(label)) & valid
        return {"ViterbiPath": out.long()[..., None]}
    return {"ViterbiPath": path[..., None]}


# ---------------------------------------------------------------------------
# warpctc / ctc_align
# ---------------------------------------------------------------------------

class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp``: amax + log1p(exp(-|x1 - x2|)) (x1 + x2 where
    that difference is NaN), with jax's jvp, t1 exp(x1 - out) + t2
    exp(x2 - out)."""

    @staticmethod
    def forward(ctx, x1, x2):
        delta = x1 - x2
        out = torch.where(torch.isnan(delta), x1 + x2,
                          torch.maximum(x1, x2)
                          + torch.log1p(torch.exp(-torch.abs(delta))))
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        return g * torch.exp(x1 - out), g * torch.exp(x2 - out)


def logaddexp(x1, x2):
    return _LogAddExp.apply(x1, x2)


@register_op("warpctc", seq_aware=True, no_vjp_outputs=("WarpCTCGrad",))
def _warpctc(ctx, ins, attrs, op=None):
    """CTC loss (reference warpctc_op.cc wraps the warp-ctc library).
    Logits [N,T,V] raw (softmax applied inside, as warp-ctc does);
    Label [N,L] int with its own '@LEN'.  Loss [N,1]."""
    logits = ins["Logits"].float()
    label = _label_2d(ins["Label"])
    blank = int(attrs.get("blank", 0))
    n, t, v = logits.shape
    lmax = label.shape[1]
    dev = logits.device
    t_lens = _lens_or_full(ctx, op, "Logits", n, t, dev)
    l_lens = _lens_or_full(ctx, op, "Label", n, lmax, dev)

    logp = torch.log_softmax(logits, dim=-1)

    # extended label sequence [blank, l1, blank, ..., lL, blank]: S=2L+1
    s = 2 * lmax + 1
    blanks = torch.full((n, lmax + 1), blank, dtype=torch.long, device=dev)
    ext = torch.stack([blanks[:, :lmax], label], dim=2).reshape(n, 2 * lmax)
    ext = torch.cat([ext, blanks[:, lmax:]], dim=1)          # [N,S]
    s_lens = 2 * l_lens + 1
    s_valid = _steps(s, dev)[None, :] < s_lens[:, None]      # [N,S]

    # the skip into an odd (label) state whose label differs from the
    # one two back
    no = torch.zeros((n, 1), dtype=torch.bool, device=dev)
    differs = label[:, 1:] != label[:, :-1]                   # [N,L-1]
    odd = torch.stack([differs, torch.zeros_like(differs)],
                      dim=2).reshape(n, -1)
    can_skip = torch.cat([no.expand(n, min(s, 3)), odd], dim=1)[:, :s]

    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    first = [logp[:, 0, blank][:, None]]
    if lmax > 0:
        first_lab = torch.gather(logp[:, 0, :], 1, label[:, :1])[:, 0]
        first.append(torch.where(l_lens > 0, first_lab, neg)[:, None])
    alpha = torch.cat(first + [neg.expand(n, s - len(first))], dim=1)

    def shift(a, by):
        return torch.cat([neg.expand(n, by), a[:, :-by]], dim=1) \
            if by < s else neg.expand(n, s)

    for t_idx in range(1, t):
        one = shift(alpha, 1)
        two = torch.where(can_skip, shift(alpha, 2), neg)
        merged = logaddexp(logaddexp(alpha, one), two)
        emit = torch.gather(logp[:, t_idx, :], 1, ext)           # [N,S]
        nxt = torch.where(s_valid, merged + emit, neg)
        live = (t_idx < t_lens)[:, None]
        alpha = torch.where(live, nxt, alpha)

    last = torch.clamp(s_lens.long() - 1, 0, s - 1)
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(last - 1, 0, s - 1)
                          [:, None])[:, 0]
    loss = -logaddexp(a_last, torch.where(l_lens > 0, a_prev, neg))
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp_min(t_lens.float(), 1.0)
    return {"Loss": loss[:, None].to(ins["Logits"].dtype),
            "WarpCTCGrad": torch.zeros_like(logits)}


@register_op("ctc_align", grad_maker=None, seq_aware=True)
def _ctc_align(ctx, ins, attrs, op=None):
    """Merge repeats then drop blanks, left-aligned (reference
    ctc_align_op.h).  Input [N,T] (or [N,T,1]) int; Output the same
    shape, the tail ``padding_value``; '@LEN' carries the new lengths."""
    x = ins["Input"]
    squeeze = x.dim() == 3
    if squeeze:
        x = x[..., 0]
    blank = int(attrs.get("blank", 0))
    pad_val = int(attrs.get("padding_value", 0))
    n, t = x.shape
    lens = _lens_or_full(ctx, op, "Input", n, t, x.device)
    steps = _steps(t, x.device)[None, :]
    valid = steps < lens[:, None]

    prev = torch.cat([torch.full((n, 1), -1, dtype=x.dtype,
                                 device=x.device), x[:, :-1]], dim=1)
    keep = (x != blank) & (x != prev) & valid
    new_lens = keep.sum(dim=1).to(torch.int32)
    # stable left-compaction: a stable sort on (drop, position)
    order = torch.argsort(torch.where(keep, steps, t + steps), dim=1,
                          stable=True)
    gathered = torch.gather(x, 1, order)
    out = torch.where(steps < new_lens[:, None], gathered,
                      torch.full((), pad_val, dtype=x.dtype,
                                 device=x.device))
    if op is not None:
        for nm in (op.outputs.get("Output") or []):
            if nm:
                ctx.set_seq_len(nm, new_lens)
    if squeeze:
        out = out[..., None]
    return {"Output": out}


# ---------------------------------------------------------------------------
# chunk_eval (host op: scheme-aware chunk extraction, a metric)
# ---------------------------------------------------------------------------

_SCHEME_KINDS = {"IOB": "BI", "IOE": "IE", "IOBES": "BIES"}


def _extract_chunks(tags, scheme, num_types, excluded):
    """-> set of (begin, end_exclusive, type); conlleval-style begin/end
    predicates (reference chunk_eval_op.h ChunkBegin/ChunkEnd for
    plain/IOB/IOE/IOBES; tag encoding = type * n_kinds + kind)."""
    if scheme == "plain":
        parsed = [(int(t), "S") for t in tags]

        def begins(prev, cur):
            return prev is None or prev[0] != cur[0]

        def ends(cur, nxt):
            return nxt is None or nxt[0] != cur[0]
    else:
        kinds = _SCHEME_KINDS[scheme]
        nk = len(kinds)
        o_tag = num_types * nk

        def parse(t):
            t = int(t)
            if t < 0 or t >= o_tag:
                return None  # O / out of range
            return (t // nk, kinds[t % nk])

        parsed = [parse(t) for t in tags]

        def begins(prev, cur):
            if prev is None or prev[0] != cur[0]:
                return True
            if scheme == "IOB":
                return cur[1] == "B"
            if scheme == "IOE":
                return prev[1] == "E"
            return cur[1] in "BS" or prev[1] in "ES"

        def ends(cur, nxt):
            if nxt is None or nxt[0] != cur[0]:
                return True
            if scheme == "IOB":
                return nxt[1] == "B"
            if scheme == "IOE":
                return cur[1] == "E"
            return cur[1] in "ES" or nxt[1] in "BS"

    chunks = set()
    start = None
    for i, cur in enumerate(parsed):
        if cur is None:
            start = None
            continue
        prev = parsed[i - 1] if i > 0 else None
        nxt = parsed[i + 1] if i + 1 < len(parsed) else None
        if start is None or begins(prev, cur):
            start = i
        if ends(cur, nxt):
            if cur[0] not in excluded:
                chunks.add((start, i + 1, cur[0]))
            start = None
    return chunks


@_host("chunk_eval")
def _chunk_eval(executor, op, scope, feed, env=None):
    """Precision/recall/F1 over extracted chunks (reference
    chunk_eval_op.cc; schemes plain/IOB/IOE/IOBES)."""
    def read(name, default=None):
        for src in (env, feed):
            if src is not None and name in src and src[name] is not None:
                return fetches_to_host([src[name]])[0]
        try:
            return fetches_to_host([scope.find_var(name)])[0]
        except KeyError:
            if default is not None:
                return default
            raise

    inf_name = op.input("Inference")[0]
    lab_name = op.input("Label")[0]
    inference = read(inf_name)
    label = read(lab_name)
    if inference.ndim == 3:
        inference = inference[..., 0]
    if label.ndim == 3:
        label = label[..., 0]
    lens = read(inf_name + "@LEN",
                default=np.full((inference.shape[0],),
                                inference.shape[1], np.int64))

    scheme = op.attr("chunk_scheme", "IOB")
    num_types = int(op.attr("num_chunk_types"))
    excluded = set(op.attr("excluded_chunk_types", []) or [])

    n_inf = n_lab = n_correct = 0
    for row in range(inference.shape[0]):
        ln = int(lens[row])
        ic = _extract_chunks(inference[row, :ln].tolist(), scheme,
                             num_types, excluded)
        lc = _extract_chunks(label[row, :ln].tolist(), scheme,
                             num_types, excluded)
        n_inf += len(ic)
        n_lab += len(lc)
        n_correct += len(ic & lc)

    precision = n_correct / n_inf if n_inf else 0.0
    recall = n_correct / n_lab if n_lab else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)

    outs = {"Precision": np.asarray([precision], np.float32),
            "Recall": np.asarray([recall], np.float32),
            "F1-Score": np.asarray([f1], np.float32),
            "NumInferChunks": np.asarray([n_inf], np.int64),
            "NumLabelChunks": np.asarray([n_lab], np.int64),
            "NumCorrectChunks": np.asarray([n_correct], np.int64)}
    for slot, val in outs.items():
        names = op.outputs.get(slot) or []
        if names and names[0]:
            _install(executor, scope, env, names[0], torch.from_numpy(val))
