"""Token-level generative serving: paged-KV prefill and decode.

Counterpart of ``paddle_tpu/serving/generative.py``: the same pre-LN
transformer LM family (``LMConfig``, ``tiny_lm``), the same paged KV
cache layout ``[L, N, bs, H, D]``, the same power-of-2 prefill and
``(batch, block-count)`` decode buckets with the same padding, and the
same Orca-style ``DecodeLoop``.  So both packages compute the same
function on the same shapes.

The JAX engine AOT-compiles one step per bucket, kept in a
``StepCache`` ladder, and donates the page arrays through each
dispatch.  Here each bucket's step reads static device buffers (the
tokens, block ids or tables, lengths), which the host fills before it
runs, and writes K/V pages IN PLACE (``kp[l, blk, off] = k``), which
replaces JAX's donated functional ``.at[].set``.  On a card each step
is captured once as a CUDA graph (``core/step_graph.capture``) and
replayed; on the CPU the same step function runs eagerly.  The
reference's three step caches (decode, decode with logits, prefill)
pick the bucket: an exact hit runs, a miss runs on the smallest
covering bucket while one background thread captures the exact one,
and with nothing covering the capture runs inline.  On the path:

- prefill attention is ``kernels.flash_attention`` (causal),
- decode attention is ``kernels.paged_attention`` through the block
  tables,
- int8 tenants' projections are ``kernels.matmul_int8_dequant``;

the f32 projections and ``lm_head`` are ``torch.matmul``, as the JAX
engine leaves them to XLA.  Everything is float32.

``dense_forward`` is the test oracle: the same LM over a whole token
list with plain dense causal attention — no paging, no kernels.

Captures and replays of one engine hold its ``_lock``, so they never
overlap, and a warm-up step before a capture runs on the padding row
(lengths 0, block ids and tables 0): its K/V writes land in the
reserved scratch block 0, never in a live sequence's page.  A capture
runs in ``thread_local`` error mode, so another tenant's thread may
replay, copy or allocate meanwhile; the launches it records are this
thread's alone (``kernels._build.recording``).

Not in this slice: prefix caching, speculative decoding, KV block
export/import for the fleet, and the metrics/trace/sanitizer hooks.
Arguments that would turn them on raise NotImplementedError.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..core import step_graph
from ..core.flags import FLAGS
from ..device import resolve_device
from ..kernels import _build
from ..kernels.flash_attention import NEG_INF, flash_attention, \
    paged_attention
from ..kernels.matmul_fused import dequantize_weight, \
    matmul_int8_dequant, quantize_weight
from .batcher import TokenScheduler
from .engine import StepCache, bucket_ladder, pow2_bucket
from .kv_cache import BlockPool

__all__ = ["LMConfig", "GenerativeEngine", "GenRequest", "DecodeLoop",
           "tiny_lm", "dense_forward", "FLAGSHIP_LM"]


# ---------------------------------------------------------------------------
# Model definition
# ---------------------------------------------------------------------------

class LMConfig:
    """Static model/runtime shape of one generative tenant."""

    def __init__(self, vocab, d_model, n_heads, n_layers, d_ff,
                 block_size=None, max_blocks=8, max_batch=None):
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.d_ff = int(d_ff)
        self.block_size = int(block_size or FLAGS.serve_kv_block_size)
        self.max_blocks = int(max_blocks)
        self.max_batch = int(max_batch or FLAGS.serve_max_batch)
        if self.d_model % self.n_heads:
            raise ValueError("d_model %% n_heads != 0")
        if self.block_size < 1 or \
                self.block_size & (self.block_size - 1):
            raise ValueError("block_size must be a positive power of "
                             "two (got %d)" % self.block_size)
        self.head_dim = self.d_model // self.n_heads
        self.max_seq = self.max_blocks * self.block_size

    def todict(self):
        return {k: getattr(self, k) for k in
                ("vocab", "d_model", "n_heads", "n_layers", "d_ff",
                 "block_size", "max_blocks", "max_batch")}


# the repo's flagship LM at full width (bench.py's transformer: vocab
# 8192, d_model 1024, 8 heads, 6 layers, d_ff 4096, sequence 2048) in
# the serving geometry: 16-token blocks, 128 per sequence, batch 16
FLAGSHIP_LM = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=6,
                   d_ff=4096, block_size=16, max_blocks=128, max_batch=16)

# weights quantized under quant='int8' (embed/pos/lm_head/LN stay fp32)
_QUANT_SLOTS = ("wqkv", "wo", "w1", "w2")


def tiny_lm(seed, vocab=256, d_model=64, n_heads=4, n_layers=2,
            d_ff=128, **cfg_kw):
    """(config, params) of a seeded LM of the serving model family;
    draws exactly the reference's numpy parameters for the same seed."""
    cfg = LMConfig(vocab, d_model, n_heads, n_layers, d_ff, **cfg_kw)
    rng = np.random.RandomState(seed)

    def w(*shape):
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    params = {"embed": w(cfg.vocab, cfg.d_model),
              "pos": w(cfg.max_seq, cfg.d_model),
              "lnf.scale": np.ones(cfg.d_model, np.float32),
              "lnf.bias": np.zeros(cfg.d_model, np.float32),
              "lm_head": w(cfg.d_model, cfg.vocab)}
    for l in range(cfg.n_layers):
        p = "l%d." % l
        params[p + "wqkv"] = w(cfg.d_model, 3 * cfg.d_model)
        params[p + "wo"] = w(cfg.d_model, cfg.d_model)
        params[p + "w1"] = w(cfg.d_model, cfg.d_ff)
        params[p + "w2"] = w(cfg.d_ff, cfg.d_model)
        for ln in ("ln1", "ln2"):
            params[p + ln + ".scale"] = np.ones(cfg.d_model, np.float32)
            params[p + ln + ".bias"] = np.zeros(cfg.d_model, np.float32)
    return cfg, params


def _layer_norm(x, scale, bias, eps=1e-5):
    """The reference's ``(x - mean) * rsqrt(var + eps) * scale + bias``
    (biased variance over the last axis), as one fused PyTorch op."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _block_fwd(mm, p, l, h, attend):
    """One transformer block: pre-LN attention (via ``attend``, which
    owns the K/V writes and attention of its mode) then the pre-LN
    tanh-gelu MLP.  ``mm(name, x)`` is the projection."""
    pre = "l%d." % l
    a = _layer_norm(h, p[pre + "ln1.scale"], p[pre + "ln1.bias"])
    h = h + mm(pre + "wo", attend(l, mm(pre + "wqkv", a)))
    m = _layer_norm(h, p[pre + "ln2.scale"], p[pre + "ln2.bias"])
    return h + mm(pre + "w2",
                  F.gelu(mm(pre + "w1", m), approximate="tanh"))


def _refuse_deferred(prefix_cache, spec_k, draft):
    for name, given in (("prefix_cache", prefix_cache),
                        ("spec_k", spec_k), ("draft", draft is not None)):
        if given:
            raise NotImplementedError(
                "%s is not ported yet (paddle_tpu_torch serves plain "
                "greedy decode in this slice)" % name)


def dense_forward(config, params, tokens, device=None):
    """Logits ``[n, vocab]`` f32 of the LM over the whole token list:
    plain dense causal attention, no paging, no kernels — the oracle
    the paged engine is checked against.  ``params`` is the reference's
    numpy dict or ``GenerativeEngine.params_from_numpy`` output (int8
    slots are dequantized with the plain function)."""
    cfg = config
    dev = resolve_device(device)

    def plain(v):
        if isinstance(v, tuple):
            q, s, chunk = v
            return dequantize_weight(q.to(dev), s.to(dev), chunk)
        if isinstance(v, torch.Tensor):
            return v.to(dev, torch.float32)
        return torch.from_numpy(np.array(v, np.float32)).to(dev)

    p = {k: plain(v) for k, v in params.items()}
    n = len(tokens)
    h_, d_ = cfg.n_heads, cfg.head_dim
    mask = torch.ones(n, n, dtype=torch.bool, device=dev).tril()

    def attend(l, qkv):
        q, k, v = (t.reshape(n, h_, d_).transpose(0, 1)
                   for t in qkv.split(cfg.d_model, dim=-1))
        s = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(d_)
        s = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
        return torch.matmul(s, v).transpose(0, 1).reshape(n, cfg.d_model)

    with torch.no_grad():
        toks = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        h = p["embed"][toks] + p["pos"][:n]
        for l in range(cfg.n_layers):
            h = _block_fwd(lambda name, x: torch.matmul(x, p[name]),
                           p, l, h, attend)
        h = _layer_norm(h, p["lnf.scale"], p["lnf.bias"])
        return torch.matmul(h, p["lm_head"])


# ---------------------------------------------------------------------------
# Requests / sequences
# ---------------------------------------------------------------------------

class GenRequest:
    """One generate request; doubles as the running-sequence state (the
    scheduler's admit/preempt unit).  ``blocks`` / ``context_len`` /
    ``out`` are reset by preemption — greedy decode regenerates the
    same tokens on re-admission."""

    __slots__ = ("prompt", "max_new", "eos_id", "future", "t_arrival",
                 "blocks", "context_len", "out", "t_first", "t_last",
                 "itl_ms", "preempted")

    def __init__(self, prompt, max_new, eos_id, future):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.future = future
        self.t_arrival = time.perf_counter()
        self.reset()
        self.preempted = 0

    def reset(self):
        self.blocks = []
        self.context_len = 0
        self.out = []
        self.t_first = None
        self.t_last = None
        self.itl_ms = []

    def result(self):
        return {"tokens": list(self.out),
                "ttft_ms": (self.t_first - self.t_arrival) * 1e3
                if self.t_first is not None else None,
                "itl_ms": list(self.itl_ms),
                "preempted": self.preempted}


# ---------------------------------------------------------------------------
# The engine: device pages + bucketed prefill/decode steps
# ---------------------------------------------------------------------------

class _BucketStep:
    """One bucket's step: its static device inputs, the step function
    over them and, on a card, the CUDA graph captured from it (with its
    outputs and the kernel launches one replay makes)."""

    __slots__ = ("inputs", "fn", "graph", "outputs", "launches")

    def __init__(self, inputs, fn, graph=None, outputs=None, launches=None):
        self.inputs = inputs
        self.fn = fn
        self.graph = graph
        self.outputs = outputs
        self.launches = launches or {}

    def run(self, **host):
        """Copy the host arrays ``host`` into the static inputs, then run
        the step: one replay on a card, the function on the CPU.  The
        outputs of a replay are the graph's: read them before the next."""
        for name, arr in host.items():
            self.inputs[name].copy_(torch.from_numpy(arr))
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.outputs


class GenerativeEngine:
    """One generative tenant: params and KV pages on the device, and the
    bucketed prefill/decode steps over them."""

    def __init__(self, config, params, quant="", kv_blocks=None,
                 name="", device=None, warm=True, prefix_cache=None,
                 spec_k=None, draft=None):
        _refuse_deferred(prefix_cache, spec_k, draft)
        self.config = config if isinstance(config, LMConfig) \
            else LMConfig(**config)
        self.name = name or "generative"
        self.quant = str(quant or "")
        if self.quant not in ("", "int8"):
            raise ValueError("unsupported quant mode %r (want ''/'int8')"
                             % (self.quant,))
        self.device = resolve_device(device)
        cfg = self.config
        n_blocks = int(kv_blocks or FLAGS.serve_kv_blocks)
        self.pool = BlockPool(n_blocks, cfg.block_size)
        self._params = self.params_from_numpy(params, self.quant,
                                              self.device)
        page_shape = (cfg.n_layers, n_blocks, cfg.block_size,
                      cfg.n_heads, cfg.head_dim)
        self._kp = torch.zeros(page_shape, dtype=torch.float32,
                               device=self.device)
        self._vp = torch.zeros(page_shape, dtype=torch.float32,
                               device=self.device)
        # held by every capture and every step of this engine
        self._lock = threading.Lock()
        # the engine's captures run on their own stream: two tenants
        # may capture at once
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # step counters: prefills, decode steps and the live rows they
        # carried (occupancy = decode_rows / decode_steps); graph
        # replays, seconds spent capturing (warm-up steps included), and
        # the bucket the latest decode step ran at
        self.prefills = 0
        self.decode_steps = 0
        self.decode_rows = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.last_decode_key = None
        # bucket ladders
        self.batch_ladder = bucket_ladder(cfg.max_batch)
        self.nb_top = cfg.max_blocks
        self.prefill_ladder = []
        s = cfg.block_size
        while s < cfg.max_seq:
            self.prefill_ladder.append(s)
            s *= 2
        self.prefill_ladder.append(cfg.max_seq)
        self._decode = StepCache(self._compile_decode,
                                 name=self.name + ".decode")
        self._decode_logits = StepCache(
            lambda key: self._compile_decode(key, with_logits=True),
            name=self.name + ".decode_logits")
        self._prefill = StepCache(self._compile_prefill,
                                  name=self.name + ".prefill")
        if warm:
            if self.device.type == "cuda":
                # every kernel's nvcc at once, before the captures
                _build.build_all()
            # decode: the whole batch ladder at the top block-count
            # bucket (covering every narrower request; tighter buckets
            # capture in the background on their first miss); prefill:
            # the whole ladder, which has no covering fallback wider
            # than a prompt's own bucket
            self._decode.warm([(b, self.nb_top)
                               for b in self.batch_ladder])
            self._prefill.warm([(s,) for s in self.prefill_ladder])

    @staticmethod
    def params_from_numpy(params, quant="", device=None):
        """The reference's numpy params dict as the port's tensors:
        float32 on the device; under ``quant='int8'`` the projection and
        MLP weights become ``(int8 q, f32 scales, chunk)`` from
        ``quantize_weight`` (embed, pos, LN and lm_head stay f32)."""
        dev = resolve_device(device)
        staged = {}
        for k, v in params.items():
            if quant == "int8" and k.split(".")[-1] in _QUANT_SLOTS:
                q, s, chunk = quantize_weight(v)
                staged[k] = (torch.from_numpy(q).to(dev),
                             torch.from_numpy(s).to(dev), int(chunk))
            else:
                staged[k] = torch.from_numpy(
                    np.array(v, np.float32)).to(dev)
        return staged

    # -- model math -----------------------------------------------------

    def _mm(self, name, x):
        """x @ W with the tenant's quantization gate: int8 weights run
        the dequantizing kernel, f32 weights torch.matmul."""
        w = self._params[name]
        if isinstance(w, tuple):
            q, s, chunk = w
            return matmul_int8_dequant(x, q, s, chunk)
        return torch.matmul(x, w)

    def _split_heads(self, qkv, rows):
        cfg = self.config
        return [t.reshape(rows, cfg.n_heads, cfg.head_dim)
                for t in qkv.split(cfg.d_model, dim=-1)]

    def _head(self, h):
        p = self._params
        h = _layer_norm(h, p["lnf.scale"], p["lnf.bias"])
        return torch.matmul(h, p["lm_head"])

    # -- bucket steps ---------------------------------------------------

    def _bucket_step(self, kind, key, padding, fn):
        """The ``_BucketStep`` of cache ``kind`` at ``key``:
        ``fn(**inputs)`` over static inputs that start as ``padding``
        ({name: numpy array}, the padding row's values); on a card
        captured under the engine's lock (the warm-up steps run on
        those padding inputs)."""
        with self._lock, torch.no_grad():
            inputs = {name: torch.from_numpy(a).to(self.device)
                      for name, a in padding.items()}

            def step():
                return fn(**inputs)

            if self.device.type != "cuda":
                return _BucketStep(inputs, step)
            t0 = time.perf_counter()
            graph, outputs, launches = step_graph.capture(
                step, "%s %r of tenant %r" % (kind, key, self.name),
                capture_error_mode="thread_local", stream=self._stream)
            self.capture_seconds += time.perf_counter() - t0
            return _BucketStep(inputs, step, graph, outputs, launches)

    def _compile_decode(self, key, with_logits=False):
        """The decode step at bucket ``(B, NB)``: one token per row in,
        K/V written through the block table, paged attention over each
        row's pages, greedy next token (and the f32 logits) out.
        Padding rows have ``lens = 0`` and tables pointing at block 0,
        and attend over ``lens + 1`` positions."""
        cfg = self.config
        bs = cfg.block_size
        bb, nbb = key
        p = self._params
        dev = self.device

        def step(tables, lens, toks):
            lens_l = lens.long()
            h = p["embed"][toks] + p["pos"][lens_l]            # [B, D]
            new_lens = lens + 1
            rows = torch.arange(bb, device=dev)
            blk = tables[rows, lens_l // bs].long()
            off = lens_l % bs

            def attend(l, qkv):
                q, k, v = self._split_heads(qkv, bb)
                # in place: replaces the donated kp.at[l, blk, off].set
                self._kp[l, blk, off] = k
                self._vp[l, blk, off] = v
                att = paged_attention(q.contiguous(), self._kp[l],
                                      self._vp[l], tables, new_lens)
                return att.reshape(bb, cfg.d_model)

            for l in range(cfg.n_layers):
                h = _block_fwd(self._mm, p, l, h, attend)
            logits = self._head(h)                              # [B, V]
            nxt = torch.argmax(logits, dim=-1)
            return (nxt, logits) if with_logits else (nxt,)

        return self._bucket_step(
            "decode_logits" if with_logits else "decode", key,
            {"tables": np.zeros((bb, nbb), np.int32),
             "lens": np.zeros(bb, np.int32),
             "toks": np.zeros(bb, np.int64)}, step)

    def _compile_prefill(self, key):
        """The prefill step at bucket ``(S,)``: the whole padded prompt
        forward, causal flash attention over the in-flight K/V, every
        position's K/V written into the sequence's blocks (positions at
        or past ``length`` to scratch block 0), the greedy first token
        from position ``length - 1``.  ``length`` is a device tensor, so
        one capture serves every prompt length of the bucket."""
        cfg = self.config
        bs = cfg.block_size
        (s_len,) = key
        p = self._params
        dev = self.device

        def step(toks, length, ids):
            pos = torch.arange(s_len, device=dev)
            h = p["embed"][toks] + p["pos"][pos]               # [S, D]
            blk = torch.where(pos < length, ids[pos // bs], 0)
            off = pos % bs

            def attend(l, qkv):
                q, k, v = self._split_heads(qkv, s_len)
                # in-place page writes replace the reference's donated
                # functional kp.at[l, blk, off].set(k)
                self._kp[l, blk, off] = k
                self._vp[l, blk, off] = v
                # causal attention over the in-flight K/V (the values
                # just written): rows < length see only real columns
                q4, k4, v4 = (t.transpose(0, 1).unsqueeze(0).contiguous()
                              for t in (q, k, v))
                att = flash_attention(q4, k4, v4, causal=True)[0]
                return att.transpose(0, 1).reshape(s_len, cfg.d_model)

            for l in range(cfg.n_layers):
                h = _block_fwd(self._mm, p, l, h, attend)
            last = h.index_select(0, length - 1)[0]             # [D]
            return (torch.argmax(self._head(last)),)

        # the warm-up's padding prompt: one token, block ids all 0
        return self._bucket_step(
            "prefill", key,
            {"toks": np.zeros(s_len, np.int64),
             "length": np.ones(1, np.int64),
             "ids": np.zeros(max(1, s_len // bs), np.int64)}, step)

    def _run(self, step, **host):
        """``step.run(**host)``; call under ``self._lock``."""
        out = step.run(**host)
        if step.graph is not None:
            self.replays += 1
        return out

    # -- prefill --------------------------------------------------------

    def prefill(self, seq):
        """Run ``seq``'s prompt through the prefill bucket that fits it;
        returns the first generated token.  ``seq.blocks`` must already
        hold the prompt's blocks (TokenScheduler.try_admit)."""
        cfg = self.config
        n = len(seq.prompt)
        if n < 1:
            raise ValueError("empty prompt")
        if n > cfg.max_seq:
            raise ValueError("prompt length %d exceeds max_seq %d "
                             "(block_size x max_blocks)" % (n, cfg.max_seq))
        tok = self.prefill_tokens(seq.prompt, seq.blocks)
        seq.context_len = n
        self.prefills += 1
        return tok

    def prefill_tokens(self, tokens, blocks):
        """Write K/V for every position of ``tokens`` into ``blocks``
        and return the greedy next token.  The prompt is padded to the
        bucket ``pick`` returns (its power-of-2 bucket, or a covering
        one while that one is captured); pad positions write to
        scratch block 0."""
        cfg = self.config
        n = len(tokens)
        want = pow2_bucket(max(n, cfg.block_size), cfg.max_seq)
        key, step = self._prefill.pick((want,))
        (s_len,) = key
        toks = np.zeros(s_len, np.int64)
        toks[:n] = tokens
        ids = np.zeros(max(1, s_len // cfg.block_size), np.int64)
        # the sequence may hold more blocks than the bucket's slots
        m = min(len(blocks), len(ids))
        ids[:m] = blocks[:m]
        with self._lock, torch.no_grad():
            nxt, = self._run(step, toks=toks,
                             length=np.array([n], np.int64), ids=ids)
            return int(nxt)

    # -- decode ---------------------------------------------------------

    def decode(self, seqs, with_logits=False):
        """One decode iteration over the running sequences; returns the
        next token per sequence."""
        out = self.decode_step(
            [s.blocks for s in seqs],
            [s.context_len for s in seqs],
            [s.out[-1] if s.out else s.prompt[-1] for s in seqs],
            with_logits=with_logits)
        self.decode_steps += 1
        self.decode_rows += len(seqs)
        for s in seqs:
            s.context_len += 1
        return out

    def decode_step(self, blocks_list, lens_list, toks_list,
                    with_logits=False):
        """Raw single-token decode over parallel lists (one entry per
        row).  Pads to the ``(batch, block-count)`` bucket ``pick``
        returns (``last_decode_key``): the power-of-2 bucket, or a
        covering one while that one is captured.  Padding rows have
        ``lens=0`` and tables pointing at block 0.  Returns the next
        tokens (numpy) and, with ``with_logits``, the f32 logits."""
        cfg = self.config
        b = len(blocks_list)
        nb = max(len(bl) for bl in blocks_list)
        want = (pow2_bucket(b, cfg.max_batch),
                pow2_bucket(nb, self.nb_top))
        cache = self._decode_logits if with_logits else self._decode
        key, step = cache.pick(want)
        bb, nbb = key
        tables = np.zeros((bb, nbb), np.int32)
        lens = np.zeros(bb, np.int32)
        toks = np.zeros(bb, np.int64)
        for i, bl in enumerate(blocks_list):
            tables[i, :len(bl)] = bl
            lens[i] = lens_list[i]
            toks[i] = toks_list[i]
        with self._lock, torch.no_grad():
            out = self._run(step, tables=tables, lens=lens, toks=toks)
            self.last_decode_key = key
            nxt = out[0][:b].cpu().numpy()
            if with_logits:
                return nxt, out[1][:b].cpu().numpy()
            return nxt

    def warm_role(self, role):
        """Warm one side of the ladder: ``'prefill'`` the prefill
        ladder; ``'decode'`` the whole ``(batch, block-count)`` grid and
        the prefill ladder (a decode worker also serves whole
        requests)."""
        if role == "prefill":
            self._prefill.warm([(s,) for s in self.prefill_ladder])
        elif role == "decode":
            self._decode.warm([(b, nb)
                               for b in self.batch_ladder
                               for nb in bucket_ladder(self.nb_top)])
            self._prefill.warm([(s,) for s in self.prefill_ladder])
        else:
            raise ValueError("unknown role %r" % (role,))

    @property
    def warm_decode_buckets(self):
        return self._decode.warm_keys

    def free_sequence(self, seq):
        seq_blocks, seq.blocks = seq.blocks, []
        if seq_blocks:
            self.pool.free(seq_blocks)

    def drain(self):
        """Join the background captures in flight."""
        for cache in (self._decode, self._decode_logits, self._prefill):
            cache.drain()

    def close(self):
        """Join the background captures, then drop the steps (their
        graphs write the pages) before the pages and the params."""
        self.drain()
        self.pool.close()
        with self._lock:
            for cache in (self._decode, self._decode_logits, self._prefill):
                cache.clear()
            self._params = {}
            self._kp = self._vp = None


# ---------------------------------------------------------------------------
# The decode loop: Orca iteration-level scheduling
# ---------------------------------------------------------------------------

class DecodeLoop:
    """One thread per generative tenant.  Each iteration: admit queued
    prefills the block pool can hold (TokenScheduler), grow/preempt for
    sequences crossing a block boundary, run ONE decode step over the
    whole running set, emit tokens, retire finished sequences.  The
    loop must survive anything — a dead loop wedges the tenant with
    unresolved futures."""

    def __init__(self, engine, queue, label=""):
        self.engine = engine
        self.queue = queue
        self.scheduler = TokenScheduler(engine.pool,
                                        engine.config.max_batch)
        self.label = label
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="serve-decode-%s" % (label or id(self)))
        self._thread.start()

    def stop(self, join=True):
        self._stop.set()
        self.queue.close()
        if join:
            self._thread.join(timeout=60)

    def _loop(self):
        running = []
        while True:
            if not running:
                req = self.queue.get(timeout=0.25)
                if req is None:
                    if self._stop.is_set() and self.queue.closed:
                        return
                    continue
                self.queue.put_front([req])   # one admission path
            try:
                self._iterate(running)
            except Exception as e:
                for seq in running:
                    self.engine.free_sequence(seq)
                    if not seq.future.done():
                        seq.future.set_exception(e)
                del running[:]

    def _iterate(self, running):
        # 1. admission: a prefill failure fails THAT request and returns
        # its blocks; the rest of the batch carries on
        for req in self.scheduler.try_admit(self.queue, len(running)):
            try:
                tok = self.engine.prefill(req)
            except Exception as e:
                self.engine.free_sequence(req)
                if not req.future.done():
                    req.future.set_exception(e)
                continue
            running.append(req)
            self._emit(req, tok, running)
        if not running:
            return
        # 2. growth/preemption: a sequence writing into a fresh block
        # this iteration needs one allocated
        bs = self.engine.config.block_size
        for seq in list(running):
            if seq not in running:
                continue
            cap = len(seq.blocks) * bs
            while seq.context_len + 1 > cap and seq in running:
                if self.scheduler.grow(seq):
                    cap += bs
                    continue
                victim = self.scheduler.pick_victim(running, seq)
                if victim is None:
                    self.engine.free_sequence(seq)
                    running.remove(seq)
                    seq.future.set_exception(RuntimeError(
                        "KV block pool too small for this sequence "
                        "(%d blocks total; raise FLAGS_serve_kv_blocks "
                        "or lower max_new_tokens)" %
                        self.engine.pool.capacity))
                    break
                self._preempt(victim, running)
        if not running:
            return
        # 3. one decode iteration over the whole running set
        toks = self.engine.decode(running)
        for seq, tok in zip(list(running), toks):
            self._emit(seq, int(tok), running)

    def _emit(self, seq, tok, running):
        now = time.perf_counter()
        if seq.t_first is None:
            seq.t_first = now
        else:
            seq.itl_ms.append((now - seq.t_last) * 1e3)
        seq.t_last = now
        seq.out.append(tok)
        done = (len(seq.out) >= seq.max_new
                or (seq.eos_id is not None and tok == seq.eos_id)
                or seq.context_len >= self.engine.config.max_seq)
        if done:
            if seq in running:
                running.remove(seq)
            self.engine.free_sequence(seq)
            seq.future.set_result(seq.result())

    def _preempt(self, victim, running):
        """Recompute-style eviction: free the victim's blocks, requeue
        it at the FRONT, and let greedy determinism regenerate its
        tokens on re-admission."""
        running.remove(victim)
        self.engine.free_sequence(victim)
        victim.reset()
        victim.preempted += 1
        self.engine.pool.note_preemption()
        self.queue.put_front([victim])
