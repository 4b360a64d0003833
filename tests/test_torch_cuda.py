"""paddle_tpu_torch's CUDA kernels against their plain PyTorch versions
on the card.  Every test is marked ``cuda`` and skips without a card
(the kernels have no CPU mode).  The file imports neither jax nor
paddle_tpu, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance atol = rtol = 1e-4: both sides accumulate in float32, in a
different order.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import (flash_attention_bwd,
                                      flash_attention_fwd_lse,
                                      flash_attention_train,
                                      matmul_int8_dequant, paged_attention)
from paddle_tpu_torch.kernels import matmul_fused as pmm
from paddle_tpu_torch.kernels.flash_attention import (
    attention_reference, flash_attention_bwd_reference,
    paged_attention_reference)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from paddle_tpu_torch import resolve_device

    return resolve_device("cuda")    # f32 cuBLAS and cuDNN, no TF32


@pytest.mark.cuda
@pytest.mark.parametrize("t,tk", [(16, 16), (100, 100), (256, 256),
                                  (64, 200)])
def test_flash_kernel_matches_plain_on_card(cuda, t, tk):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 8, t, 128, device=cuda, generator=g)
    k, v = (torch.randn(2, 8, tk, 128, device=cuda, generator=g)
            for _ in range(2))
    for causal in (False, True):
        out, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
        ro, rl = attention_reference(q, k, v, 128 ** -0.5, causal)
        torch.testing.assert_close(out, ro, **TOL)
        torch.testing.assert_close(lse, rl, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,tk", [(2, 16, 16), (2, 100, 100),
                                    (1, 256, 256), (2, 64, 200),
                                    (1, 200, 64)])
def test_flash_bwd_kernels_match_plain_on_card(cuda, b, t, tk):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, do = (torch.randn(b, 8, t, 128, device=cuda, generator=g)
             for _ in range(2))
    k, v = (torch.randn(b, 8, tk, 128, device=cuda, generator=g)
            for _ in range(2))
    for causal in (False, True):
        out, lse = attention_reference(q, k, v, 128 ** -0.5, causal)
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             128 ** -0.5, causal)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **TOL)


@pytest.mark.cuda
def test_flash_train_autograd_runs_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(1, 8, 128, 128, device=cuda, generator=g,
                           requires_grad=True) for _ in range(3))
    w = torch.randn(1, 8, 128, 128, device=cuda, generator=g)
    out, _ = flash_attention_train(q, k, v, causal=True)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    qd, kd, vd = (x.detach().requires_grad_() for x in (q, k, v))
    ref, _ = attention_reference(qd, kd, vd, 128 ** -0.5, True)
    want = torch.autograd.grad((ref * w).sum(), (qd, kd, vd))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nb", [(1, 1), (3, 8), (16, 128)])
def test_paged_kernel_matches_plain_on_card(cuda, b, nb):
    bs = 16
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, 8, 128, device=cuda, generator=g)
    kp = torch.randn(64, bs, 8, 128, device=cuda, generator=g)
    vp = torch.randn(64, bs, 8, 128, device=cuda, generator=g)
    tables = torch.randint(1, 64, (b, nb), device=cuda, generator=g,
                           dtype=torch.int32)
    lens = torch.randint(1, nb * bs + 1, (b,), device=cuda, generator=g,
                         dtype=torch.int32)
    out = paged_attention(q, kp, vp, tables, lens)
    ref = paged_attention_reference(q, kp, vp, tables, lens, 128 ** -0.5)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 16, 100])
def test_int8_kernel_matches_plain_on_card(cuda, m):
    rng = np.random.RandomState(0)
    w = (rng.randn(1024, 256) * 0.1).astype(np.float32)
    q, s, chunk = pmm.quantize_weight(w, chunk=256)
    q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    x = torch.from_numpy(rng.randn(m, 1024).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(256).astype(np.float32)).to(cuda)
    res = torch.from_numpy(rng.randn(m, 256).astype(np.float32)).to(cuda)
    for act in ("", "relu", "gelu"):
        out = matmul_int8_dequant(x, q, s, chunk, bias, res, act)
        ref = pmm.matmul_int8_reference(x, q, s, chunk, bias, res, act)
        torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.cuda
def test_int8_decode_rows_are_batch_invariant(cuda):
    """A row's result does not depend on how many rows share the call
    (decode buckets M = 1..16 run one kernel with one summation order)."""
    rng = np.random.RandomState(1)
    w = (rng.randn(1024, 512) * 0.1).astype(np.float32)
    q, s, chunk = pmm.quantize_weight(w)
    q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    x = torch.from_numpy(rng.randn(16, 1024).astype(np.float32)).to(cuda)
    full = matmul_int8_dequant(x, q, s, chunk)
    for m in (1, 2, 4, 8):
        assert torch.equal(matmul_int8_dequant(x[:m].contiguous(), q, s,
                                               chunk), full[:m])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(33, 4, 7), (100, 68, 130),
                                   (128, 256, 256), (257, 1024, 3072),
                                   (2048, 1024, 1024)])
def test_matmul_epilogue_kernel_matches_plain_on_card(cuda, m, k, n):
    """K4 for every epilogue (act x bias x residual x pre), ragged M and
    N edges and N % 4 != 0 (the scalar-load instantiation) included."""
    rng = np.random.RandomState(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(cuda)

    x, w = t(m, k), t(k, n, scale=k ** -0.5)
    bias, res = t(n), t(m, n)
    for act in ("", "relu", "gelu"):
        for b, r in ((None, None), (bias, None), (bias, res), (None, res)):
            out, pre = pmm.matmul_epilogue(x, w, b, r, act,
                                           save_preact=True)
            want, want_pre = pmm.matmul_epilogue_reference(x, w, b, r, act)
            torch.testing.assert_close(out, want, **TOL)
            torch.testing.assert_close(pre, want_pre, **TOL)
            torch.testing.assert_close(
                pmm.matmul_epilogue(x, w, b, r, act), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 4), (37, 100), (64, 256), (8, 640),
                                 (300, 1024)])
def test_add_ln_kernel_matches_plain_on_card(cuda, m, d):
    rng = np.random.RandomState(1)
    x, y = (torch.from_numpy(rng.randn(m, d).astype(np.float32)).to(cuda)
            for _ in range(2))
    scale = torch.from_numpy(
        (rng.rand(d) + 0.5).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(d).astype(np.float32)).to(cuda)
    for sc, bi in ((None, None), (scale, bias), (scale, None)):
        got = pmm.add_ln(x, y, sc, bi)
        want = pmm.add_ln_reference(x, y, sc, bi)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 6, device=cuda)                   # K = 6
    with pytest.raises(ValueError, match="multiple of 4"):
        pmm.matmul_epilogue(x, torch.randn(6, 8, device=cuda))
    w = torch.randn(8, 4, device=cuda).t()               # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        pmm.matmul_epilogue(torch.randn(3, 4, device=cuda), w)
    big = torch.randn(4, 2048, device=cuda)              # D > 1024
    with pytest.raises(ValueError, match="1024"):
        pmm.add_ln(big, big)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 2, 16, 96, device=cuda)       # head_dim 96
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd_lse(q, q, q)
    q = torch.randn(1, 2, 16, 128, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd_lse(q, q, q)
    pages = torch.randn(4, 8, 2, 128, device=cuda)   # block_size 8
    tables = torch.ones(1, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="block_size"):
        paged_attention(torch.randn(1, 2, 128, device=cuda), pages, pages,
                        tables, lens)


@pytest.mark.cuda
def test_executor_step_on_card_runs_the_flash_kernels(cuda):
    """One training step of a small LM with head_dim 128 through
    Executor(CUDAPlace(0)): K1 once and K2/K3 once per layer, and the
    card's loss is the CPU executor's from the same parameters."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(
            vocab_size=64, seq_len=128, d_model=256, n_head=2, n_layers=2,
            d_ff=64)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    toks = np.random.RandomState(0).randint(0, 64, (2, 129))
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    reset_launches()
    got, = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=[loss], scope=card)
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 2, counts
    want, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=[loss], scope=host)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.cuda
def test_executor_fused_step_on_card_runs_the_fused_kernels(cuda):
    """One training step of the small fused LM (FLAGS_transformer_fuse)
    through Executor(CUDAPlace(0)): per layer one QKV, three epilogue
    matmuls and two add + LN seams, plus the lm_head; the card's loss
    and gradients are the CPU executor's from the same parameters."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(
            vocab_size=64, seq_len=128, d_model=256, n_head=2, n_layers=2,
            d_ff=64, fuse_transformer=True)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    fetch = [loss.name] + sorted(p.name + "@GRAD"
                                 for p in main.all_parameters())
    toks = np.random.RandomState(0).randint(0, 64, (2, 129))
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=card)
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    assert counts["matmul_epilogue"] == 2 * 4 + 1, counts
    assert counts["add_ln"] == 2 * 2, counts
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 2, counts
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        # relative Frobenius norm, as chip_smoke.py's oracle: a relu
        # input within rounding of 0 may take the other branch
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), name


# K6: every epilogue combination on ragged shapes -- M not a multiple of
# the 128-pixel tile, the stem's scalar gather (Ci = 3, 7x7, stride 2,
# padding 3), Co = 64 (half a tile), 3x3 and 1x1 stages with float4
# gathers, a stride-2 1x1
CONV_SHAPES = [(3, 23, 3, 64, 7, 2, 3), (2, 9, 64, 128, 3, 1, 1),
               (2, 7, 256, 68, 1, 2, 0), (1, 5, 40, 256, 3, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_stage_kernel_matches_plain_on_card(cuda, shape):
    from paddle_tpu_torch.kernels import conv_fused as pcf

    n, h, ci, co, k, s, p = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(n, h, h, ci, device=cuda, generator=g)
    w = torch.randn(k, k, ci, co, device=cuda, generator=g) * \
        (k * k * ci) ** -0.5
    ho = (h + 2 * p - k) // s + 1
    a = torch.rand(co, device=cuda, generator=g) + 0.5
    b = torch.randn(co, device=cuda, generator=g)
    r = torch.randn(n, ho, ho, co, device=cuda, generator=g)
    for stats in (False, True):
        for affine in (None, (a, b)):
            for res in (None, r):
                for act in ("", "relu"):
                    kw = dict(stats=stats, affine=affine, residual=res,
                              act=act)
                    got = pcf.conv2d_nhwc(x, w, (s, s), (p, p), **kw)
                    want = pcf.conv2d_nhwc_reference(x, w, (s, s), (p, p),
                                                     **kw)
                    if not stats:
                        got, want = (got,), (want,)
                    torch.testing.assert_close(got[0], want[0], **TOL)
                    if stats:
                        _, rel = pcf.stats_error(x, w, (s, s), (p, p),
                                                 got[1], got[2])
                        assert rel <= pcf.STATS_RTOL, rel


@pytest.mark.cuda
def test_conv_stage_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from paddle_tpu_torch.kernels import conv_fused as pcf

    x = torch.randn(1, 8, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        pcf.conv2d_nhwc(x, torch.randn(3, 3, 16, 6, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        pcf.conv2d_nhwc(x.transpose(1, 2), torch.randn(3, 3, 16, 8,
                                                       device=cuda))
    with pytest.raises(ValueError, match="float32"):
        pcf.conv2d_nhwc(x.double(), torch.randn(3, 3, 16, 8, device=cuda,
                                                dtype=torch.float64))


@pytest.mark.cuda
def test_executor_fused_resnet_step_on_card_runs_the_conv_stage(cuda):
    """One Momentum step of the fused cifar10 ResNet, depth 8, batch 4
    (FLAGS_conv_layout=NHWC) through Executor(CUDAPlace(0)): K6 once per
    conv stage (9); the card's loss and gradients are the CPU
    executor's from the same parameters."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = resnet.get_model(data_set="cifar10", depth=8,
                                      data_format="NHWC", fused_stages=True)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    fetch = [loss.name] + sorted(p.name + "@GRAD"
                                 for p in main.all_parameters()
                                 if p.trainable)
    rng = np.random.RandomState(0)
    feed = {"data": rng.rand(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=card)
    assert KERNELS["conv_stage"].launches == 9
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), name
