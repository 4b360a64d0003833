"""Runtime flags — the subset of ``paddle_tpu/core/flags.py`` the port
reads.

Same ``FLAGS_<name>`` environment override and attribute access as the
JAX package's registry; only the flags this port reads are defined.
"""
from __future__ import annotations

import os

__all__ = ["FLAGS", "define_flag"]


def _parse(raw, default):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


class _Flags:
    """Attribute-style access; unknown flags raise AttributeError."""

    def __init__(self):
        object.__setattr__(self, "_defs", {})

    def define(self, name, default, help=""):
        raw = os.environ.get("FLAGS_" + name)
        value = _parse(raw, default) if raw is not None else default
        self._defs[name] = {"value": value, "default": default,
                            "help": help}

    def __getattr__(self, name):
        try:
            return self._defs[name]["value"]
        except KeyError:
            raise AttributeError("undefined flag %r" % name)

    def __setattr__(self, name, value):
        if name not in self._defs:
            raise AttributeError("undefined flag %r" % name)
        self._defs[name]["value"] = value


FLAGS = _Flags()


def define_flag(name, default, help=""):
    FLAGS.define(name, default, help)


define_flag("serve_max_batch", 16,
            "generative serving: most sequences in one decode step; the "
            "top of the power-of-2 batch bucket ladder")
define_flag("serve_kv_block_size", 16,
            "generative serving: tokens per KV cache block (power of "
            "two)")
define_flag("serve_kv_blocks", 512,
            "generative serving: KV cache blocks in a tenant's paged "
            "pool (block 0 is the reserved padding scratch block)")
define_flag("serve_prefix_cache", False,
            "generative serving: copy-on-write prefix KV reuse.  On, a "
            "tenant keeps a radix index over prompt token ids at block "
            "granularity: admission shares the cached prefix blocks by "
            "refcount (the pool's shared_blocks), prefill computes and "
            "stores ONLY the un-cached suffix (prefix_hits / "
            "prefix_tokens / prefix_tokens_cached), a shared block "
            "written mid-block is copied first (COW, cow_copies), and "
            "finished prompts' blocks park in a refcount-zero LRU "
            "instead of the free list — evicted only under allocation "
            "pressure.  Per-tenant override: "
            "load_generative(prefix_cache=...)")
define_flag("serve_spec_k", 0,
            "generative serving: speculative decoding draft depth.  "
            "k > 0 makes the decode loop propose k tokens per iteration "
            "from the tenant's draft LM (a load_generative(draft=...) "
            "requirement) and verify all k in ONE batched target step — "
            "greedy acceptance keeps the longest matching prefix plus "
            "the target's correction token, so output stays identical "
            "to non-speculative greedy decode.  0 (default) is plain "
            "one-token decode.  Per-tenant override: "
            "load_generative(spec_k=...)")
define_flag("conv_layout", "NCHW",
            "convnet pipeline layout: 'NCHW' (reference contract; the "
            "default) or 'NHWC' — models that honor the flag (e.g. "
            "models/resnet.py get_model) run the LayoutTranspiler NHWC "
            "pass: data_format propagated through conv/pool/bn/"
            "elementwise chains, conv weights pinned HWIO at creation, "
            "and conv+BN+act stages fused into the conv-stage kernel "
            "(kernels/conv_fused.py).  Acts at PROGRAM BUILD time "
            "(get_model) — flip it before building, not on a built "
            "program; the NCHW program stays selectable for bisection")
define_flag("conv_fused_stages", True,
            "with conv_layout=NHWC, also run FuseConvBNActPass "
            "(conv+BN(+residual)(+relu) -> fused_conv2d_bn_act backed "
            "by kernels/conv_fused.py); off = layout pass alone, for "
            "attributing wins between the two levers")
define_flag("transformer_fuse", False,
            "transformer block fusion: models that honor the flag "
            "(models/transformer.py get_model) run "
            "FuseTransformerBlockPass before backward generation — the "
            "QKV projections collapse to one wide matmul, "
            "matmul+bias(+gelu/relu)(+dropout)(+residual) chains and "
            "residual-add+layer_norm chains become fused ops backed by "
            "kernels/matmul_fused.py (f32 accumulator epilogues, "
            "explicit saved-activation grad lowerings).  Acts at PROGRAM "
            "BUILD time; the unfused program stays the default for "
            "bisection")
define_flag("bn_bf16", False,
            "under AMP, let batch_norm consume/produce bf16 (statistics "
            "stay f32 internally, like layer_norm) instead of casting "
            "its inputs to f32; halves BN-chain activation bytes on "
            "HBM-bound conv nets")
define_flag("cudnn_deterministic", False,
            "run the convs (conv2d, depthwise_conv2d, conv3d, "
            "conv2d_transpose, the fused stage's backward) on cuDNN's "
            "deterministic algorithms: cuDNN's default weight-gradient "
            "algorithms add with atomics, so a conv net's step is not "
            "bit-repeatable without it (the port's own flag)")
define_flag("sanitizer", "off",
            "runtime sanitizers (core/sanitizer.py): 'off' (default; a "
            "guarded site costs one flag read) or 'buffers' ('all' "
            "reads as 'buffers' here): a read of the KV pages while a "
            "step that writes them is in flight or through a stale "
            "epoch, a block decref without a reference, and a "
            "mis-shaped KV import raise BufferLifetimeError naming "
            "var/op/step/site")
define_flag("fault_spec", "",
            "fault injection spec: point:action:value[:limit],... "
            "(distributed/resilience.py; actions drop, delay, error)")
define_flag("fleet_lease_s", 2.0,
            "router-side worker lease: a worker unreachable for this "
            "long is evicted from membership and its in-flight "
            "requests re-prefilled on a survivor")
define_flag("fleet_lease_interval_s", 0.5,
            "how often the router pings every member (lease renewal "
            "cadence; each sweep also recomputes the availability)")
define_flag("fleet_hedge_s", 0.0,
            "hedged re-dispatch: a request not finished after this "
            "many seconds gets a second full attempt on different "
            "workers, first completion wins (0 disables)")
define_flag("fleet_request_deadline_s", 120.0,
            "end-to-end per-request deadline across all router "
            "attempts (DeadlineExceeded past it)")
define_flag("fleet_max_attempts", 4,
            "bounded per-request dispatch attempts per router "
            "attempt-loop (each eviction/hedge runs its own loop)")
define_flag("fleet_prefix_tokens", 8,
            "token-id prefix length the router hashes for "
            "prefix-affinity prefill placement")
define_flag("fleet_decode_credits", 16,
            "router admission valve: max outstanding dispatches per "
            "decode worker; excess arrivals queue in the router "
            "instead of flooding worker KV pools into PoolExhausted "
            "retry storms")
define_flag("fleet_prefill_slots", 4,
            "max concurrent prefill+export+migrate admissions per "
            "prefill worker; excess calls queue (backpressure) instead "
            "of racing the block pool")
