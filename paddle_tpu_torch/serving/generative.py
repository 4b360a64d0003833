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

Two levers ride on top, both off by default, as in the reference:

- **copy-on-write prefix caching** (``FLAGS_serve_prefix_cache`` /
  ``load_generative(prefix_cache=True)``): ``PrefixCache`` keeps a
  block-granular trie over prompt token ids; admission shares the
  resident prefix blocks by refcount (``BlockPool.share``), copies a
  partially matching tail block first (``BlockPool.cow`` +
  ``copy_block``), and the suffix prefill (``_prefill_cached``, keyed by
  the suffix bucket) computes only the un-cached positions, its
  attention ``kernels.paged_attention`` over the shared prefix and the
  suffix just written, one row a position;
- **speculative decoding** (``FLAGS_serve_spec_k`` /
  ``load_generative(spec_k=k, draft=(config, params))``): a draft
  engine whose pages mirror the target's block ids proposes k tokens a
  round in one captured step (``_propose``, k chained one-token steps,
  each argmax feeding the next on the device), and the target verifies
  them in one step of ``B x (k + 1)`` paged-attention rows
  (``_verify``); greedy acceptance keeps the longest matching prefix
  plus the target's correction token, so the tokens are those of plain
  greedy decode.

Each of their steps is a ``StepCache`` bucket captured like the rest.

The disaggregated fleet (``serving/fleet.py``) moves a prompt's pages
between engines: ``export_blocks`` gathers them to host memory and
``import_blocks`` writes them into freshly allocated blocks IN PLACE
(``index_copy_`` along the block axis), so every graph captured before
the import reads them; the reference rebinds its donated pool instead.
Every step, COW copy and import is bracketed by the pool's epoch guard
(``core/sanitizer.BufferEpochGuard``, ``kv_epoch``), as the reference's
donations are.  Not in this port: the metrics and trace hooks (the
reference's counters are plain attributes of the engine and its pool).
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..core import sanitizer as _san
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
           "PrefixCache", "tiny_lm", "dense_forward", "FLAGSHIP_LM"]


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
                 "itl_ms", "preempted", "cached_len", "draft_len")

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
        # prompt tokens whose K/V came from shared prefix blocks at
        # admission (prefill computes positions cached_len..n-1 only)
        self.cached_len = 0
        # positions with valid K/V in the DRAFT engine's pages (spec
        # decoding; always <= context_len, re-prefilled after a reset)
        self.draft_len = 0

    def token_at(self, pos):
        """The token AT position ``pos`` of the whole sequence (prompt
        then generated): the draft's catch-up feed."""
        n = len(self.prompt)
        return self.prompt[pos] if pos < n else self.out[pos - n]

    def result(self):
        return {"tokens": list(self.out),
                "ttft_ms": (self.t_first - self.t_arrival) * 1e3
                if self.t_first is not None else None,
                "itl_ms": list(self.itl_ms),
                "preempted": self.preempted}


# ---------------------------------------------------------------------------
# Prefix caching: a trie over prompt token ids at block granularity
# ---------------------------------------------------------------------------

class PrefixCache:
    """Block-granularity prompt-prefix index over one engine's pool.

    The trie's edges are ``block_size``-token chunks; each node owns the
    block holding that chunk's K/V.  The index holds NO references: a
    node's block is either referenced by live sequences or parked in
    the pool's refcount-zero cached LRU, and when allocation pressure
    reclaims a parked block the pool's eviction callback drops its node
    (and the unreachable subtree below it).  K/V is a function of the
    token prefix, so every prompt that walks the same chunks can share
    the same pages.

    Admission (``acquire``): the prompt's longest indexed chunk path is
    SHARED by refcount; a partial tail whose tokens prefix an indexed
    chunk is copied on write (the sequence writes its own suffix K/V
    into that block); the rest is a plain allocation.  The final prompt
    token is never served from the cache: the suffix prefill has to
    compute something to emit the first generated token.

    Lock order: the pool's eviction callback runs UNDER the pool lock
    and takes the index lock, so no index method calls into the pool
    while it holds the index lock (the lookup snapshots under the lock,
    then shares and allocates outside it; ``share`` returning False
    closes the snapshot-to-share race as a cold miss)."""

    def __init__(self, engine):
        self.engine = engine
        self.pool = engine.pool
        self.block_size = engine.config.block_size
        self._root = {}       # chunk tuple -> {"block", "children"}
        self._by_block = {}   # block id -> (parent children dict, chunk)
        self._lock = threading.Lock()
        self.pool.set_evict_callback(self._on_evict)

    def _lookup(self, prompt):
        """(shared block ids, cow source block or None, cached token
        count) for ``prompt``; the caller holds the index lock."""
        n = len(prompt)
        bs = self.block_size
        shared = []
        children = self._root
        i = 0
        # full-chunk walk, capped so position n - 1 stays un-cached
        while (i + 1) * bs <= n - 1:
            nd = children.get(tuple(prompt[i * bs:(i + 1) * bs]))
            if nd is None:
                break
            shared.append(nd["block"])
            children = nd["children"]
            i += 1
        cached = i * bs
        # partial tail: the child chunk sharing the longest common prefix
        # with the remaining cache-eligible tokens is the COW source —
        # its early positions' K/V is exactly ours
        tail = prompt[cached:n - 1][:bs]
        cow_src, best = None, 0
        for chunk, nd in (children.items() if tail else ()):
            m = 0
            for a, b in zip(chunk, tail):
                if a != b:
                    break
                m += 1
            if m > best:
                cow_src, best = nd["block"], m
        return shared, cow_src, cached + best

    def probe(self, prompt):
        """(shared block count, cached token count) the index would
        serve for ``prompt`` right now."""
        with self._lock:
            shared, cow_src, cached = self._lookup(list(prompt))
        return len(shared) + (cow_src is not None), cached

    def acquire(self, req):
        """Stock ``req.blocks`` for its whole prompt: shared prefix
        blocks by refcount, a COW copy for a partially matching tail
        chunk, fresh blocks for the rest; ``req.cached_len`` is the
        count of tokens whose K/V needs no recompute.  False — every
        reference rolled back — when the pool cannot supply the
        un-cached remainder (the scheduler requeues the request)."""
        prompt = req.prompt
        n = len(prompt)
        total = self.pool.blocks_for(n)
        with self._lock:
            shared, cow_src, cached_len = self._lookup(prompt)
        pin = shared + ([cow_src] if cow_src is not None else [])
        if pin and not self.pool.share(pin):
            # an eviction raced the lookup: the whole lookup is cold
            shared, cow_src, cached_len, pin = [], None, 0, []
        blocks = list(shared)
        if cow_src is not None:
            dst = self.pool.cow(cow_src, copy=self.engine.copy_block)
            if dst is None:
                self.pool.free(pin)
                return False
            blocks.append(dst)
        fresh_n = total - len(blocks)
        if fresh_n > 0:
            fresh = self.pool.alloc(fresh_n)
            if fresh is None:
                self.pool.free(blocks)
                return False
            blocks.extend(fresh)
        req.blocks = blocks
        req.cached_len = cached_len
        self.pool.note_prefix_lookup(n, cached_len)
        return True

    def insert(self, seq):
        """Index ``seq``'s fully written prompt blocks after a
        successful prefill.  A chunk already indexed keeps its block
        (this sequence's duplicate stays un-indexed and goes back to the
        free list on release); a new chunk's block is marked cacheable,
        so it PARKS instead of freeing when the sequence lets go."""
        prompt = seq.prompt
        bs = self.block_size
        fresh = []
        with self._lock:
            children = self._root
            for i in range(len(prompt) // bs):
                chunk = tuple(prompt[i * bs:(i + 1) * bs])
                nd = children.get(chunk)
                if nd is None:
                    b = int(seq.blocks[i])
                    nd = {"block": b, "children": {}}
                    children[chunk] = nd
                    self._by_block[b] = (children, chunk)
                    fresh.append(b)
                children = nd["children"]
        if fresh:
            self.pool.set_cacheable(fresh)

    def _on_evict(self, block):
        """The pool's eviction callback (runs UNDER the pool lock):
        drop ``block``'s node and return the blocks of the subtree below
        it, unreachable now (all parked: a live descendant would pin its
        ancestors live too)."""
        with self._lock:
            ent = self._by_block.pop(int(block), None)
            if ent is None:
                return ()
            children, chunk = ent
            nd = children.pop(chunk, None)
            if nd is None:
                return ()
            orphans = []
            stack = [nd["children"]]
            while stack:
                for d in stack.pop().values():
                    orphans.append(d["block"])
                    self._by_block.pop(d["block"], None)
                    stack.append(d["children"])
            return orphans

    @property
    def nodes(self):
        with self._lock:
            return len(self._by_block)


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


def _padded_rows(blocks_list, lens_list, toks_list, bb, nbb):
    """A one-token step's host inputs at bucket ``(bb, nbb)``: the rows'
    block tables, lengths and tokens; padding rows have length 0 and
    every table slot at block 0."""
    tables = np.zeros((bb, nbb), np.int32)
    lens = np.zeros(bb, np.int32)
    toks = np.zeros(bb, np.int64)
    for i, bl in enumerate(blocks_list):
        tables[i, :len(bl)] = bl
        lens[i] = lens_list[i]
        toks[i] = toks_list[i]
    return {"tables": tables, "lens": lens, "toks": toks}


class GenerativeEngine:
    """One generative tenant: params and KV pages on the device, and the
    bucketed prefill/decode steps over them.  ``prefix_cache`` and
    ``spec_k`` default to ``FLAGS_serve_prefix_cache`` and
    ``FLAGS_serve_spec_k``; ``spec_k > 0`` needs ``draft=(config,
    params)``, a small LM of the same vocab and paging geometry."""

    def __init__(self, config, params, quant="", kv_blocks=None,
                 name="", device=None, warm=True, prefix_cache=None,
                 spec_k=None, draft=None):
        self.config = config if isinstance(config, LMConfig) \
            else LMConfig(**config)
        self.name = name or "generative"
        self.quant = str(quant or "")
        if self.quant not in ("", "int8"):
            raise ValueError("unsupported quant mode %r (want ''/'int8')"
                             % (self.quant,))
        self.spec_k = int(FLAGS.serve_spec_k if spec_k is None
                          else spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (got %d)" % self.spec_k)
        if self.spec_k > 0:
            draft = self._draft_config(draft)
        self.device = resolve_device(device)
        cfg = self.config
        n_blocks = int(kv_blocks or FLAGS.serve_kv_blocks)
        self.pool = BlockPool(n_blocks, cfg.block_size)
        self.prefix_cache = None
        self.draft = None
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
        # the pages' write/re-bind epoch: every step that writes them is
        # bracketed begin()/rebind(), so a reader holding an epoch can
        # tell whether the pages changed since (FLAGS_sanitizer=buffers)
        self._kv_guard = _san.BufferEpochGuard("kv_pool:%s" % self.name)
        self._kv_steps = 0
        # the engine's captures run on their own stream: two tenants
        # may capture at once
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # step counters: prefills, decode iterations (a speculative round
        # is one) and the live rows they carried (occupancy =
        # decode_rows / decode_steps); bucket steps run and the graph
        # replays among them, seconds spent capturing (warm-up steps
        # included), and the bucket the latest decode step ran at
        self.prefills = 0
        self.decode_steps = 0
        self.decode_rows = 0
        self.steps = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.last_decode_key = None
        # speculative rounds, the draft tokens proposed (k a row a
        # round) and accepted (the correction token not counted: the
        # accept rate is accepted / proposed), and host seconds in the
        # draft's steps (catch-up + propose) and the target's verify
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_draft_s = 0.0
        self.spec_verify_s = 0.0
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
        # warmed only when their feature is on: the suffix prefill of a
        # prefix-cache hit, keyed by the suffix bucket; the verify of a
        # speculative round, keyed (batch, blocks, k + 1); the draft's
        # fused k-step proposal, keyed (batch, blocks, k)
        self._prefill_cached = StepCache(
            self._compile_prefill_cached,
            name=self.name + ".prefill_cached")
        self._verify = StepCache(self._compile_verify,
                                 name=self.name + ".verify")
        self._verify_logits = StepCache(
            lambda key: self._compile_verify(key, with_logits=True),
            name=self.name + ".verify_logits")
        self._propose = StepCache(self._compile_propose,
                                  name=self.name + ".propose")
        try:
            if warm:
                if self.device.type == "cuda":
                    # every kernel's nvcc at once, before the captures
                    _build.build_all()
                # decode: the whole batch ladder at the top block-count
                # bucket (covering every narrower request; tighter
                # buckets capture in the background on their first
                # miss); prefill: the whole ladder, which has no
                # covering fallback wider than a prompt's own bucket
                self._decode.warm([(b, self.nb_top)
                                   for b in self.batch_ladder])
                self._prefill.warm([(s,) for s in self.prefill_ladder])
            if (FLAGS.serve_prefix_cache if prefix_cache is None
                    else prefix_cache):
                self.prefix_cache = PrefixCache(self)
                if warm:
                    self._prefill_cached.warm(
                        [(s,) for s in self.prefill_ladder])
            if self.spec_k > 0:
                self._init_draft(draft, n_blocks, warm)
        except Exception:
            # a half-built engine drops its draft, captures and pages
            self.close()
            raise

    def _draft_config(self, draft):
        """``(LMConfig, params)`` of the draft, checked against the
        target: it shares the target's block tables, so its vocab and
        paging geometry must match exactly."""
        cfg = self.config
        if draft is None:
            raise ValueError(
                "spec_k=%d needs a draft model: "
                "load_generative(..., draft=(config, params))"
                % self.spec_k)
        dcfg, dparams = draft
        dcfg = dcfg if isinstance(dcfg, LMConfig) else LMConfig(**dcfg)
        for f in ("vocab", "block_size", "max_blocks", "max_batch"):
            if getattr(dcfg, f) != getattr(cfg, f):
                raise ValueError(
                    "draft/target %s mismatch (%r != %r): the draft "
                    "shares the target's block tables, so its paging "
                    "geometry and token space must match exactly"
                    % (f, getattr(dcfg, f), getattr(cfg, f)))
        return dcfg, dparams

    def _init_draft(self, draft, n_blocks, warm):
        """The speculative draft: a second GenerativeEngine (float32, no
        prefix cache, no draft of its own) whose pages MIRROR the
        target's block ids — same block count, same geometry — so the
        sequences' block tables serve both.  Its pool is a shadow,
        never allocated from; its K/V validity is ``seq.draft_len``."""
        dcfg, dparams = draft
        self.draft = GenerativeEngine(
            dcfg, dparams, quant="", kv_blocks=n_blocks,
            name=self.name + ".draft", device=self.device, warm=False,
            prefix_cache=False, spec_k=0)
        if warm:
            # the draft runs one-token decode steps (catch-up), the
            # fused proposal and the occasional re-prefill; the target
            # verifies on the (batch, blocks, k + 1) ladder
            d = self.draft
            d._decode.warm([(b, d.nb_top) for b in self.batch_ladder])
            d._propose.warm([(b, d.nb_top, self.spec_k)
                             for b in self.batch_ladder])
            d._prefill.warm([(s,) for s in d.prefill_ladder])
            self._verify.warm([(b, self.nb_top, self.spec_k + 1)
                               for b in self.batch_ladder])

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

    def _compile_prefill_cached(self, key):
        """The SUFFIX prefill at suffix bucket ``(S,)``: the prompt's
        first ``start`` positions are resident in shared prefix blocks,
        so only the ``count`` un-cached tokens run.  Row i is position
        ``start + i``: its K/V is written through the block ids, and it
        attends through K7 over the whole table with ``start + i + 1``
        positions, so causality falls out of the page gather.  The
        greedy first token (and its logits) from row ``count - 1``.
        ``start`` and ``count`` are device tensors, so one capture
        serves every prompt of its bucket; rows at or past ``count``
        write to scratch block 0."""
        cfg = self.config
        bs = cfg.block_size
        (s_len,) = key
        nb = cfg.max_blocks
        p = self._params
        dev = self.device

        def step(toks, start, count, ids):
            rows = torch.arange(s_len, device=dev)
            live = rows < count
            pos = torch.where(live, start + rows, 0)
            h = p["embed"][toks] + p["pos"][pos]               # [S, D]
            blk = torch.where(live, ids[pos // bs].long(), 0)
            off = pos % bs
            # K7 takes contiguous int32 tables and lengths
            tables = ids.expand(s_len, nb).contiguous()
            lens = torch.where(live, pos + 1, 1).int()

            def attend(l, qkv):
                q, k, v = self._split_heads(qkv, s_len)
                self._kp[l, blk, off] = k
                self._vp[l, blk, off] = v
                att = paged_attention(q.contiguous(), self._kp[l],
                                      self._vp[l], tables, lens)
                return att.reshape(s_len, cfg.d_model)

            for l in range(cfg.n_layers):
                h = _block_fwd(self._mm, p, l, h, attend)
            logits = self._head(h.index_select(0, count - 1)[0])  # [V]
            return torch.argmax(logits), logits

        # the warm-up's padding row: one token at position 0, block ids
        # all 0 (it writes scratch block 0 only)
        return self._bucket_step(
            "prefill_cached", key,
            {"toks": np.zeros(s_len, np.int64),
             "start": np.zeros(1, np.int64),
             "count": np.ones(1, np.int64),
             "ids": np.zeros(nb, np.int32)}, step)

    def _compile_propose(self, key):
        """The draft's FUSED k-step greedy decode at bucket ``(B, NB,
        k)``: k one-token steps in one captured graph, each argmax the
        next step's token on the device, none back to the host.  The
        K/V of the k positions lands in the pages as k decode steps
        would write it.  Padding rows (``lens = 0``, tables 0) write to
        scratch block 0."""
        cfg = self.config
        bs = cfg.block_size
        bb, nbb, k = key
        p = self._params
        dev = self.device

        def step(tables, lens, toks):
            rows = torch.arange(bb, device=dev)
            cur, props = toks, []
            for j in range(k):
                pos = lens.long() + j
                h = p["embed"][cur] + p["pos"][pos]
                blk = tables[rows, pos // bs].long()
                off = pos % bs
                new_lens = (pos + 1).int()

                def attend(l, qkv, blk=blk, off=off, new_lens=new_lens):
                    q, kk, v = self._split_heads(qkv, bb)
                    self._kp[l, blk, off] = kk
                    self._vp[l, blk, off] = v
                    att = paged_attention(q.contiguous(), self._kp[l],
                                          self._vp[l], tables, new_lens)
                    return att.reshape(bb, cfg.d_model)

                for l in range(cfg.n_layers):
                    h = _block_fwd(self._mm, p, l, h, attend)
                cur = torch.argmax(self._head(h), dim=-1)
                props.append(cur)
            return (torch.stack(props, dim=1),)                 # [B, k]

        return self._bucket_step(
            "propose", key,
            {"tables": np.zeros((bb, nbb), np.int32),
             "lens": np.zeros(bb, np.int32),
             "toks": np.zeros(bb, np.int64)}, step)

    def _compile_verify(self, key, with_logits=False):
        """The speculative VERIFY at bucket ``(B, NB, k + 1)``: each
        sequence's k + 1 candidates (its last token and the draft's k
        proposals) run as k + 1 rows of one step.  Row (i, j) feeds
        candidate j at position ``lens[i] + j``, writes its K/V and
        attends through K7 over ``lens[i] + j + 1`` positions (the
        earlier candidates' K/V, written this step, included), so its
        greedy token is the one plain decode would produce there.  Rows
        past a mismatch write K/V that later steps overwrite before
        reading (attention never reads past a row's length)."""
        cfg = self.config
        bs = cfg.block_size
        bb, nbb, k1 = key
        r = bb * k1
        p = self._params
        dev = self.device

        def step(tables, lens, toks):
            pos = (lens.long()[:, None]
                   + torch.arange(k1, device=dev)[None]).reshape(r)
            h = p["embed"][toks.reshape(r)] + p["pos"][pos]    # [R, D]
            # each sequence's table repeated for its k + 1 rows, as the
            # contiguous int32 [R, NB] K7 takes (at B = 1 the reshape
            # alone is a view with a zero stride)
            tab = tables[:, None].expand(bb, k1, nbb).reshape(
                r, nbb).contiguous()
            blk = tab[torch.arange(r, device=dev), pos // bs].long()
            off = pos % bs
            new_lens = (pos + 1).int()

            def attend(l, qkv):
                q, k, v = self._split_heads(qkv, r)
                self._kp[l, blk, off] = k
                self._vp[l, blk, off] = v
                att = paged_attention(q.contiguous(), self._kp[l],
                                      self._vp[l], tab, new_lens)
                return att.reshape(r, cfg.d_model)

            for l in range(cfg.n_layers):
                h = _block_fwd(self._mm, p, l, h, attend)
            logits = self._head(h)                              # [R, V]
            nxt = torch.argmax(logits, dim=-1).reshape(bb, k1)
            if with_logits:
                return nxt, logits.reshape(bb, k1, cfg.vocab)
            return (nxt,)

        return self._bucket_step(
            "verify_logits" if with_logits else "verify", key,
            {"tables": np.zeros((bb, nbb), np.int32),
             "lens": np.zeros(bb, np.int32),
             "toks": np.zeros((bb, k1), np.int64)}, step)

    def _begin(self, op):
        """Open the pages' epoch guard for a write by ``op`` (closed by
        ``self._kv_guard.rebind()``); call under ``self._lock``."""
        self._kv_steps += 1
        self._kv_guard.begin(op, self._kv_steps)

    def _run(self, op, step, **host):
        """``step.run(**host)`` bracketed by the pages' epoch guard as
        step ``op``; call under ``self._lock``."""
        self._begin(op)
        out = step.run(**host)
        self._kv_guard.rebind()
        self.steps += 1
        if step.graph is not None:
            self.replays += 1
        return out

    # -- prefill --------------------------------------------------------

    def prefill(self, seq):
        """Run ``seq``'s prompt through the prefill bucket that fits it;
        returns the first generated token.  ``seq.blocks`` must already
        hold the prompt's blocks (TokenScheduler.try_admit).  With a
        prefix-cache hit recorded on the sequence (``seq.cached_len``),
        only the un-cached suffix is computed."""
        cfg = self.config
        n = len(seq.prompt)
        if n < 1:
            raise ValueError("empty prompt")
        if n > cfg.max_seq:
            raise ValueError("prompt length %d exceeds max_seq %d "
                             "(block_size x max_blocks)" % (n, cfg.max_seq))
        cached = seq.cached_len
        if self.prefix_cache is not None and 0 < cached < n:
            tok = self._prefill_suffix(seq.prompt, seq.blocks, cached)
        else:
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
            nxt, = self._run("prefill", step, toks=toks,
                             length=np.array([n], np.int64), ids=ids)
            return int(nxt)

    def _prefill_suffix(self, tokens, blocks, start, with_logits=False):
        """Suffix-only prefill (a prefix-cache hit): positions
        ``start..n-1`` computed and written, the cached prefix read
        through the pages.  Bucketed by the SUFFIX length.  Returns the
        first generated token (and, with ``with_logits``, its f32
        logits)."""
        cfg = self.config
        n = len(tokens)
        count = n - start
        want = pow2_bucket(max(count, cfg.block_size), cfg.max_seq)
        key, step = self._prefill_cached.pick((want,))
        (s_len,) = key
        toks = np.zeros(s_len, np.int64)
        toks[:count] = tokens[start:]
        ids = np.zeros(cfg.max_blocks, np.int32)
        ids[:len(blocks)] = blocks
        with self._lock, torch.no_grad():
            nxt, logits = self._run(
                "prefill_cached", step, toks=toks,
                start=np.array([start], np.int64),
                count=np.array([count], np.int64), ids=ids)
            if with_logits:
                return int(nxt), logits.cpu().numpy()
            return int(nxt)

    def copy_block(self, src, dst):
        """Copy one block's K/V pages across all layers: the COW copy
        (BlockPool.cow calls it before dropping the shared reference).
        Under the engine's lock, so no capture of this engine is in
        flight; on a card on the engine's stream, ordered after the
        work queued so far and before the work queued next."""
        with self._lock, torch.no_grad():
            self._begin("cow")
            if self._stream is None:
                self._kp[:, dst] = self._kp[:, src]
                self._vp[:, dst] = self._vp[:, src]
            else:
                cur = torch.cuda.current_stream(self.device)
                self._stream.wait_stream(cur)
                with torch.cuda.stream(self._stream):
                    self._kp[:, dst] = self._kp[:, src]
                    self._vp[:, dst] = self._vp[:, src]
                cur.wait_stream(self._stream)
            self._kv_guard.rebind()

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
        host = _padded_rows(blocks_list, lens_list, toks_list, *key[:2])
        with self._lock, torch.no_grad():
            out = self._run("decode", step, **host)
            self.last_decode_key = key
            nxt = out[0][:b].cpu().numpy()
            if with_logits:
                return nxt, out[1][:b].cpu().numpy()
            return nxt

    # -- speculative decoding -------------------------------------------

    def propose_step(self, blocks_list, lens_list, toks_list, k):
        """Fused k-token greedy proposal over parallel lists: ONE step
        runs k chained decode steps (the draft's propose), returning the
        [B, k] proposed tokens.  Callers own the length accounting
        (each row's pages gained k positions)."""
        cfg = self.config
        b = len(blocks_list)
        nb = max(len(bl) for bl in blocks_list)
        want = (pow2_bucket(b, cfg.max_batch),
                pow2_bucket(nb, self.nb_top), int(k))
        key, step = self._propose.pick(want)
        bb, nbb, kk = key
        if kk != k:
            raise RuntimeError("propose bucket k mismatch (%d != %d)"
                               % (kk, k))
        host = _padded_rows(blocks_list, lens_list, toks_list, bb, nbb)
        with self._lock, torch.no_grad():
            props, = self._run("propose", step, **host)
            return props[:b].cpu().numpy()

    def verify_step(self, seqs, props, with_logits=False):
        """ONE target step verifying ``props`` (the draft's [B, k]
        proposals): row (i, j) of the ``(batch, blocks, k + 1)`` bucket
        runs candidate j of sequence i.  Returns the [B, k + 1] greedy
        tokens (and, with ``with_logits``, the f32 logits [B, k + 1,
        V]); acceptance is the caller's (``spec_decode``)."""
        cfg = self.config
        b = len(seqs)
        k1 = int(props.shape[1]) + 1
        nb = max(len(s.blocks) for s in seqs)
        want = (pow2_bucket(b, cfg.max_batch),
                pow2_bucket(nb, self.nb_top), k1)
        cache = self._verify_logits if with_logits else self._verify
        key, step = cache.pick(want)
        bb, nbb, kk1 = key
        if kk1 != k1:
            raise RuntimeError("verify bucket k+1 mismatch (%d != %d)"
                               % (kk1, k1))
        tables = np.zeros((bb, nbb), np.int32)
        lens = np.zeros(bb, np.int32)
        toks = np.zeros((bb, k1), np.int64)
        for i, s in enumerate(seqs):
            tables[i, :len(s.blocks)] = s.blocks
            lens[i] = s.context_len
            toks[i, 0] = s.out[-1] if s.out else s.prompt[-1]
            toks[i, 1:] = props[i]
        with self._lock, torch.no_grad():
            out = self._run("verify", step, tables=tables, lens=lens,
                            toks=toks)
            nxt = out[0][:b].cpu().numpy()
            if with_logits:
                return nxt, out[1][:b].cpu().numpy()
            return nxt

    def spec_decode(self, seqs):
        """One speculative round over the running set: catch the draft's
        pages up to the target's context (a whole re-prefill for a fresh
        or preemption-reset sequence, one-token steps otherwise), draft
        k proposals, verify them all in ONE target step, and accept the
        longest matching prefix plus the target's correction token.
        Returns one list of >= 1 tokens a sequence: each the token plain
        greedy decode would have produced, in order.

        Positions: with target context c, verify row j writes position
        c + j, and an accepted prefix of length m advances the context
        to c + m + 1.  The draft's pages are valid through position
        c + m (its proposals matched there), which is the new context
        minus one when m < k: only a full accept leaves the draft one
        catch-up step behind."""
        k, d = self.spec_k, self.draft
        t_draft = 0.0
        for s in seqs:
            if s.draft_len == 0 and s.context_len > 0:
                t0 = time.perf_counter()
                d.prefill_tokens([s.token_at(i)
                                  for i in range(s.context_len)], s.blocks)
                t_draft += time.perf_counter() - t0
                s.draft_len = s.context_len
        while True:
            behind = [s for s in seqs if s.draft_len < s.context_len]
            if not behind:
                break
            t0 = time.perf_counter()
            d.decode_step([s.blocks for s in behind],
                          [s.draft_len for s in behind],
                          [s.token_at(s.draft_len) for s in behind])
            t_draft += time.perf_counter() - t0
            for s in behind:
                s.draft_len += 1
        b = len(seqs)
        t0 = time.perf_counter()
        props = d.propose_step(
            [s.blocks for s in seqs], [s.draft_len for s in seqs],
            [s.out[-1] if s.out else s.prompt[-1] for s in seqs], k)
        t_draft += time.perf_counter() - t0
        for s in seqs:
            s.draft_len += k
        t0 = time.perf_counter()
        ver = self.verify_step(seqs, props)
        t_verify = time.perf_counter() - t0
        emitted, accepted = [], 0
        for i, s in enumerate(seqs):
            g = [int(t) for t in ver[i]]
            m = 0
            while m < k and int(props[i, m]) == g[m]:
                m += 1
            emitted.append(g[:m + 1])
            s.context_len += m + 1
            s.draft_len = s.context_len - (1 if m == k else 0)
            accepted += m
        self.spec_rounds += 1
        self.spec_proposed += b * k
        self.spec_accepted += accepted
        self.spec_draft_s += t_draft
        self.spec_verify_s += t_verify
        self.decode_steps += 1
        self.decode_rows += b
        return emitted

    # -- the pages' epoch, and KV migration (serving/fleet.py) ----------

    @property
    def kv_epoch(self):
        """Write generation of the pages (bumps at every step that writes
        them under FLAGS_sanitizer=buffers)."""
        return self._kv_guard.epoch

    def kv_pages(self):
        """Debug access to the live page tensors: ``(kp, vp, epoch)``,
        taken under the engine's lock.  With the buffer sanitizer on, a
        call while a step is in flight raises BufferLifetimeError;
        validate a retained handle later with ``check_kv_epoch``."""
        with self._lock:
            self._kv_guard.check()
            return self._kp, self._vp, self._kv_guard.epoch

    def check_kv_epoch(self, epoch):
        """Raise BufferLifetimeError when pages observed at ``epoch`` have
        been written since (a no-op with the sanitizer off)."""
        self._kv_guard.check(epoch=epoch, var="kv_pool")

    def export_blocks(self, blocks):
        """Host copies of the K/V pages behind ``blocks`` and the epoch
        they were read at: ``(k_pages, v_pages, epoch)``, each a float32
        numpy array ``[L, len(blocks), bs, H, D]``.  Under the engine's
        lock with a guard check, so an export racing a step in flight is
        a named BufferLifetimeError.  On a card the gather runs on the
        engine's stream, after the work queued so far, into page-locked
        host memory, and the return waits for that copy (after the lock
        is released: later steps are ordered after it on the stream):
        the caller may free the blocks, and the next prompt overwrite
        them, at once."""
        with self._lock, torch.no_grad():
            self._kv_guard.check()
            epoch = self._kv_guard.epoch
            ids = torch.as_tensor([int(b) for b in blocks],
                                  dtype=torch.long)
            if self._stream is None:
                return (self._kp.index_select(1, ids).numpy(),
                        self._vp.index_select(1, ids).numpy(), epoch)
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            out = []
            with torch.cuda.stream(self._stream):
                ids = ids.to(self.device)
                for pages in (self._kp, self._vp):
                    g = pages.index_select(1, ids)
                    host = torch.empty(g.shape, dtype=g.dtype,
                                       pin_memory=True)
                    host.copy_(g, non_blocking=True)
                    out.append(host)
                done = torch.cuda.Event()
                done.record(self._stream)
        done.synchronize()
        return out[0].numpy(), out[1].numpy(), epoch

    def import_blocks(self, blocks, k_pages, v_pages):
        """Install migrated K/V pages into ``blocks`` (already allocated
        from this engine's pool by the caller).  Shapes must be exactly
        ``[L, len(blocks), bs, H, D]`` float32: a mismatch trips the
        buffer sanitizer by name instead of scattering garbage into live
        pages.  The write goes INTO the page tensors (``index_copy_``
        along the block axis), never a rebinding, so every captured
        bucket graph, which holds the pages by address, reads the
        imported pages.  Bracketed begin/rebind like a step; returns the
        post-install epoch (the MigrateKV handshake value).  On a card
        the host pages go once into page-locked memory (a received
        payload is a read-only buffer), then to the card and into the
        pages on the engine's stream, after the work queued so far.  The
        return waits for that copy, after the lock is released: later
        steps are ordered after it on the engine's stream already, so
        the decode loop need not wait for it, and the staged pages only
        have to outlive it."""
        cfg = self.config
        ids = [int(b) for b in blocks]
        if any(b == 0 for b in ids):
            raise ValueError("cannot import into reserved block 0")
        want = (cfg.n_layers, len(ids), cfg.block_size,
                cfg.n_heads, cfg.head_dim)
        pages = [np.asarray(x) for x in (k_pages, v_pages)]
        if any(x.shape != want or x.dtype != np.float32 for x in pages):
            _san.trip("kv_pool:%s" % self.name, op="migrate_in",
                      site="import_blocks: page shape %r/%r != %r "
                           "(torn or mis-framed migration)"
                           % (pages[0].shape, pages[1].shape, want),
                      epoch=self._kv_guard.epoch)
        cuda = self._stream is not None
        staged = []
        for x in pages:
            t = torch.empty(want, dtype=torch.float32, pin_memory=cuda)
            t.numpy()[...] = x
            staged.append(t)
        idx = torch.as_tensor(ids, dtype=torch.long)
        done = None
        with self._lock, torch.no_grad():
            self._begin("migrate_in")
            if not cuda:
                self._kp.index_copy_(1, idx, staged[0])
                self._vp.index_copy_(1, idx, staged[1])
            else:
                cur = torch.cuda.current_stream(self.device)
                self._stream.wait_stream(cur)
                with torch.cuda.stream(self._stream):
                    idx = idx.to(self.device)
                    for pages, t in zip((self._kp, self._vp), staged):
                        pages.index_copy_(
                            1, idx, t.to(self.device, non_blocking=True))
                    done = torch.cuda.Event()
                    done.record(self._stream)
                cur.wait_stream(self._stream)
            self._kv_guard.rebind()
            epoch = self._kv_guard.epoch
        if done is not None:
            done.synchronize()
        return epoch

    def warm_role(self, role):
        """Warm one side of the ladder: ``'prefill'`` the prefill
        ladder; ``'decode'`` the whole ``(batch, block-count)`` grid and
        the prefill ladder (a decode worker also serves whole
        requests).  On a card every kernel's nvcc runs at once first."""
        if role not in ("prefill", "decode"):
            raise ValueError("unknown role %r" % (role,))
        if self.device.type == "cuda":
            _build.build_all()
        if role == "prefill":
            self._prefill.warm([(s,) for s in self.prefill_ladder])
        else:
            self._decode.warm([(b, nb)
                               for b in self.batch_ladder
                               for nb in bucket_ladder(self.nb_top)])
            self._prefill.warm([(s,) for s in self.prefill_ladder])

    @property
    def warm_decode_buckets(self):
        return self._decode.warm_keys

    def free_sequence(self, seq):
        seq_blocks, seq.blocks = seq.blocks, []
        if seq_blocks:
            self.pool.free(seq_blocks)

    def _caches(self):
        return (self._decode, self._decode_logits, self._prefill,
                self._prefill_cached, self._verify, self._verify_logits,
                self._propose)

    def drain(self):
        """Join the background captures in flight (the draft's first)."""
        if self.draft is not None:
            self.draft.drain()
        for cache in self._caches():
            cache.drain()

    def close(self):
        """Close the draft, join the background captures, then drop the
        steps (their graphs write the pages) before the pages and the
        params."""
        if self.draft is not None:
            self.draft.close()
        self.drain()
        self.pool.close()
        with self._lock:
            for cache in self._caches():
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
                                        engine.config.max_batch,
                                        prefix_cache=engine.prefix_cache)
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
            if req.blocks and req.context_len:
                # migrated in (serving/fleet.py): the prompt's pages are
                # resident and ``out`` holds the first token, so joining
                # the batch is the admission; no prefill
                if len(req.out) >= req.max_new or (
                        req.eos_id is not None and req.out
                        and req.out[-1] == req.eos_id):
                    self.engine.free_sequence(req)
                    if not req.future.done():
                        req.future.set_result(req.result())
                    continue
                running.append(req)
                continue
            try:
                tok = self.engine.prefill(req)
            except Exception as e:
                self.engine.free_sequence(req)
                if not req.future.done():
                    req.future.set_exception(e)
                continue
            if self.engine.prefix_cache is not None:
                # index the fully written prompt blocks: the NEXT
                # request sharing this prefix admits against them
                self.engine.prefix_cache.insert(req)
            running.append(req)
            self._emit(req, tok, running)
        if not running:
            return
        # a speculative iteration when every sequence has room for the
        # k + 1 verify positions; otherwise (the tail of a sequence near
        # max_seq) plain decode — the tokens are the same either way
        eng = self.engine
        spec = eng.spec_k > 0 and eng.draft is not None and not any(
            s.context_len + eng.spec_k + 1 > eng.config.max_seq
            for s in running)
        need = eng.spec_k + 1 if spec else 1
        # 2. growth/preemption: a sequence writing into a fresh block
        # this iteration needs one allocated (a speculative iteration
        # writes k + 1 positions, so it provisions that far)
        bs = eng.config.block_size
        for seq in list(running):
            if seq not in running:
                continue
            cap = len(seq.blocks) * bs
            while seq.context_len + need > cap and seq in running:
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
        # 3. one decode iteration over the whole running set; a
        # speculative round emits up to k + 1 tokens a sequence
        if not spec:
            toks = eng.decode(running)
            for seq, tok in zip(list(running), toks):
                self._emit(seq, int(tok), running)
            return
        for seq, toks in zip(list(running), eng.spec_decode(running)):
            # replay the round a token at a time, so _emit's checks
            # (max_new, eos, max_seq) see the context plain decode would
            seq.context_len -= len(toks)
            for tok in toks:
                seq.context_len += 1
                self._emit(seq, int(tok), running)
                if seq not in running:
                    break      # finished mid-round; the rest is dropped

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
