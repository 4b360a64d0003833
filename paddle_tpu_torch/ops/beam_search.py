"""Beam-search ops.

Counterpart of ``paddle_tpu/ops/beam_search.py``, op for op (parity:
reference operators/beam_search_op.cc, per-step candidate selection,
and beam_search_decode_op.cc, the end-of-loop backtrack, as the book
machine_translation decode program drives them: each step the model
computes the top-k candidate ids and their ACCUMULATED log scores, and
``beam_search`` keeps the best ``beam_size`` beams of each source
sentence).

As in the JAX package, a step is one batched selection over [N, B*K]
on the device and ancestry is an explicit ``parent_idx`` output ([N*B]
gather indices); ``beam_search_decode`` walks the stacked per-step
arrays back once, after the loop, on the device.

Ties are jax's on both devices: ``jax.lax.top_k`` puts the lower index
first among equal scores and ``jnp.argsort`` is stable, so the
selections here are stable sorts (``ops/tensor.top_k``; ``torch.topk``'s
order among ties is unspecified and differs between the CPU and CUDA).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.tensor import top_k

NEG_INF = -1e9


@register_op("beam_search", grad_maker=None)
def _beam_search(ctx, ins, attrs, op=None):
    """One step of beam growth.

    Inputs (N sentences x B beams flattened on dim 0):
      pre_ids     [N*B, 1] int  the previous step's token per beam
      pre_scores  [N*B, 1] f32  the accumulated log-prob per beam
      ids         [N*B, K] int  candidate token ids (the step's top k)
      scores      [N*B, K] f32  the accumulated log-prob of each
    Attrs: beam_size, end_id.
    Outputs: selected_ids [N*B, 1], selected_scores [N*B, 1], parent_idx
    [N*B] int32 (the flat beam each winner grew from).  A finished beam
    (pre_id == end_id) competes with its frozen score and re-emits
    end_id (reference PruneEndBeams keeps it out of growth)."""
    pre_ids = ins["pre_ids"].reshape(-1)
    pre_scores = ins["pre_scores"].reshape(-1).float()
    ids = ins["ids"]
    scores = ins["scores"].float()
    beam_size = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])

    nb, k = scores.shape
    n = nb // beam_size
    dev = scores.device
    finished = (pre_ids == end_id)[:, None]                  # [NB, 1]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)

    # a finished beam offers exactly one candidate: (end_id, its score)
    cand_scores = torch.where(finished, neg, scores)
    first = (torch.arange(k, device=dev) == 0)[None, :]
    frozen = torch.where(first & finished, pre_scores[:, None], neg)
    cand_scores = torch.maximum(cand_scores, frozen)
    cand_ids = torch.where(finished, torch.full((), end_id, dtype=ids.dtype,
                                                device=dev), ids)

    flat_scores = cand_scores.reshape(n, beam_size * k)
    flat_ids = cand_ids.reshape(n, beam_size * k)
    top_scores, top_pos = top_k(flat_scores, beam_size)
    sel_ids = torch.gather(flat_ids, 1, top_pos).reshape(nb, 1)
    beam_of = top_pos // k                                    # local beam
    parent = beam_of + torch.arange(n, device=dev)[:, None] * beam_size
    return {"selected_ids": sel_ids.to(pre_ids.dtype),
            "selected_scores": top_scores.reshape(nb, 1),
            "parent_idx": parent.reshape(nb).to(torch.int32)}


@register_op("beam_search_decode", grad_maker=None)
def _beam_search_decode(ctx, ins, attrs, op=None):
    """Backtrack the stacked per-step (ids, scores, parents) into whole
    beams.

    Inputs, the TensorArrays the decode loop wrote: Ids [cap, N*B, 1],
    Scores [cap, N*B, 1], Parents [cap, N*B].  Attrs: beam_size, end_id.
    Outputs: SentenceIds [N, B, cap] int (end_id padded), best beam
    first; SentenceScores [N, B] f32 accumulated log-prob.  The walk is
    a reverse loop over the capacity on the device, steps past the
    array's size masked by its device size (no host read)."""
    ids_arr, sc_arr, par_arr = ins["Ids"], ins["Scores"], ins["Parents"]
    beam_size = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])

    cap = ids_arr.buffer.shape[0]
    nb = ids_arr.buffer[0].numel()
    n = nb // beam_size
    buf_ids = ids_arr.buffer.reshape(cap, nb)
    buf_sc = sc_arr.buffer.reshape(cap, nb).float()
    buf_par = par_arr.buffer.reshape(cap, nb).long()
    size = ids_arr.size.reshape(()).long()
    dev = buf_ids.device

    last = torch.clamp(size - 1, 0, cap - 1).reshape(1)
    final_scores = buf_sc.index_select(0, last)[0]              # [NB]

    end = torch.full((), end_id, dtype=buf_ids.dtype, device=dev)
    cur = torch.arange(nb, device=dev)
    outs = [None] * cap
    for t in range(cap - 1, -1, -1):
        valid = t < size
        outs[t] = torch.where(valid, buf_ids[t][cur], end)
        cur = torch.where(valid, buf_par[t][cur], cur)
    sent = torch.stack(outs, dim=1).reshape(n, beam_size, cap)
    scores = final_scores.reshape(n, beam_size)
    order = torch.argsort(-scores, dim=1, stable=True)
    sent = torch.gather(sent, 1, order[:, :, None].expand(-1, -1, cap))
    scores = torch.gather(scores, 1, order)
    return {"SentenceIds": sent, "SentenceScores": scores}
