"""The port's reader-op chain (``ops/reader_ops.py`` under
``fluid.layers.io``) against the JAX package's, on the CPU.

Each case of ``tests/test_reader_ops.py`` is built in both packages from
the same numpy samples (MNIST-shaped: 784 floats and an int64 label)
written by each package's ``recordio_writer``, and driven through the
same script of ``exe.run`` steps, ``EOFException`` s and ``reset()`` s.
Bars:

- the batches the ``read`` op pops: equal bit for bit where the order is
  deterministic (the shuffle and random readers draw from numpy
  ``RandomState`` with the reference's seeds); with ``thread_num`` > 1
  the epoch's rows equal as multisets;
- ``fluid.core.EOFException`` at the same step in both;
- losses within rtol 1e-4 (``tests/test_torch_train.py``'s bar: the same
  f32 math in another order), the port starting from the reference's
  parameters.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.fluid.io import set_scope_arrays

SHAPES = dict(shapes=[[-1, 784], [-1, 1]], lod_levels=[0, 0],
              dtypes=["float32", "int64"])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(784).astype(np.float32),
             np.asarray([rng.randint(0, 10)], np.int64)) for _ in range(n)]


def _write(fluid, path, n, seed):
    data = _samples(n, seed)
    return fluid.recordio_writer.convert_reader_to_recordio_file(
        path, lambda: iter(data))


def _train_head(fluid, img, label):
    fc = fluid.layers.fc(img, size=10, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=fc,
                                                        label=label))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _preprocess(fluid, reader, with_fc):
    p = fluid.layers.io.Preprocessor(reader)
    with p.block():
        img, lbl = p.inputs()
        if with_fc:
            out = fluid.layers.fc(img, size=16, act="tanh",
                                  param_attr=fluid.ParamAttr(name="pp_w"),
                                  bias_attr=False)
        else:
            out = fluid.layers.scale(img, scale=2.0, bias=-1.0)
        p.outputs(out, lbl)
    return p()


# (files as (n, seed), the program builder, the script, whether the
# epoch's order is free); the script: ints are runs, "eof" a run that
# must raise EOFException, "reset" reader.reset()
def _mnist_chain(fluid, paths):
    r = fluid.layers.io.open_recordio_file(paths[0], **SHAPES)
    r = fluid.layers.io.shuffle(r, buffer_size=25)
    r = fluid.layers.io.batch(r, batch_size=10)
    r = fluid.layers.io.double_buffer(r)
    img, label = fluid.layers.io.read_file(r)
    return r, [img, label, _train_head(fluid, img, label)]


def _simple(decorate=None, pass_num=1, batch_size=10, out="img"):
    def build(fluid, paths):
        r = fluid.layers.io.open_recordio_file(paths[0], pass_num=pass_num,
                                               **SHAPES)
        r = fluid.layers.io.batch(r, batch_size=batch_size)
        if decorate is not None:
            r = decorate(fluid, r)
        img, label = fluid.layers.io.read_file(r)
        src = img if out == "img" else label
        return r, [img, label, fluid.layers.reduce_sum(src)]

    return build


def _open_files(thread_num):
    def build(fluid, paths):
        r = fluid.layers.io.open_files(paths, thread_num=thread_num,
                                       **SHAPES)
        r = fluid.layers.io.batch(r, batch_size=10)
        img, label = fluid.layers.io.read_file(r)
        return r, [img, label, fluid.layers.reduce_sum(img)]

    return build


def _random(fluid, paths):
    r = fluid.layers.io.random_data_generator(
        low=-1.0, high=1.0, shapes=[[-1, 8], [-1, 3]], lod_levels=[0, 0])
    r = fluid.layers.io.batch(r, batch_size=4)
    a, b = fluid.layers.io.read_file(r)
    return r, [a, b, fluid.layers.reduce_max(a)]


def _pre(with_fc):
    def build(fluid, paths):
        r = fluid.layers.io.open_recordio_file(paths[0], **SHAPES)
        r = fluid.layers.io.batch(r, batch_size=5 if with_fc else 10)
        r = _preprocess(fluid, r, with_fc)
        img, lbl = fluid.layers.io.read_file(r)
        return r, [img, lbl, fluid.layers.reduce_mean(img)]

    return build


CASES = {
    "recordio_read_train_eof_reset": (
        [(50, 0)], _mnist_chain, [5, "eof", "reset", 5], False),
    "pass_num_multiplies_epochs": (
        [(20, 5)], _simple(pass_num=2), [4, "eof"], False),
    "double_buffer_mid_epoch_reset": (
        [(40, 7)],
        _simple(lambda f, r: f.layers.io.double_buffer(r)),
        [1, "reset", 4, "eof"], False),
    "open_files_concatenates": (
        [(15, 1), (15, 2)], _open_files(1), [3, "eof", "reset", 1], False),
    "random_data_generator": ([], _random, [3], False),
    "batch_reader_drops_partial": (
        [(25, 3)], _simple(), [2, "eof"], False),
    "multi_pass_reader": (
        [(20, 3)], _simple(lambda f, r: f.layers.io.multi_pass(r, 3)),
        [6, "eof", "reset", 6], False),
    "threaded_reader": (
        [(30, 4)],
        _simple(lambda f, r: f.layers.io.threaded(r, capacity=2),
                out="label"),
        [3, "eof", "reset", 3], False),
    "open_files_thread_pool": (
        [(10, 10), (10, 11), (10, 12)], _open_files(3),
        [3, "eof", "reset", 3], True),
    "custom_reader_preprocessor": ([(20, 5)], _pre(False), [2], False),
    "custom_reader_with_parameterized_layer": (
        [(10, 6)], _pre(True), [2], False),
}


def _drive(pkg, case, tmp_path):
    """The case's script in one package: a list of ("run", fetches) and
    ("eof",) entries, and the parameters' names."""
    fluid = jfluid if pkg == "jax" else tfluid
    files, build, script, _ = CASES[case]
    d = os.path.join(str(tmp_path), pkg)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, (n, seed) in enumerate(files):
        p = os.path.join(d, "f%d.recordio" % i)
        assert _write(fluid, p, n, seed) == n
        paths.append(p)
    main, startup = fluid.Program(), fluid.Program()
    scope = JScope() if pkg == "jax" else tfluid.Scope()
    with fluid.scope_guard(scope), fluid.program_guard(main, startup), \
            fluid.unique_name.guard():
        reader, fetch = build(fluid, paths)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        params = sorted(p.name for p in main.all_parameters())
        return fluid, main, exe, scope, reader, fetch, script, params


def _run_script(fluid, main, exe, scope, reader, fetch, script):
    out = []
    with fluid.scope_guard(scope):
        for step in script:
            if step == "reset":
                reader.reset()
                out.append(("reset",))
            elif step == "eof":
                with pytest.raises(fluid.core.EOFException):
                    exe.run(main, fetch_list=fetch)
                out.append(("eof",))
            else:
                for _ in range(step):
                    out.append(("run", [np.asarray(v) for v in
                                        exe.run(main, fetch_list=fetch)]))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_chain_matches_the_reference(case, tmp_path):
    j = _drive("jax", case, tmp_path)
    t = _drive("port", case, tmp_path)
    jparams, tparams = j[-1], t[-1]
    assert jparams == tparams
    if jparams:     # the port trains from the reference's parameters
        set_scope_arrays(t[3], {n: np.asarray(j[3].find_var(n))
                                for n in jparams}, "cpu")
    jout = _run_script(*j[:-1])
    tout = _run_script(*t[:-1])
    assert [e[0] for e in jout] == [e[0] for e in tout]
    free_order = CASES[case][3]
    epochs_j, epochs_t = [[]], [[]]
    for je, te in zip(jout, tout):
        if je[0] != "run":
            epochs_j.append([])
            epochs_t.append([])
            continue
        (jimg, jlab, jval), (timg, tlab, tval) = je[1], te[1]
        # ints: the port keeps int64 where jax (x64 off) narrows to int32
        assert timg.dtype == jimg.dtype and tlab.dtype.kind == jlab.dtype.kind
        if free_order:
            epochs_j[-1].append(np.concatenate(
                [jimg, jlab.astype(np.float32)], 1))
            epochs_t[-1].append(np.concatenate(
                [timg, tlab.astype(np.float32)], 1))
            continue
        if case == "custom_reader_with_parameterized_layer":
            # the sub-block's fc: the same f32 math in another order
            np.testing.assert_allclose(timg, jimg, rtol=1e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(timg, jimg)
        np.testing.assert_array_equal(tlab, jlab)
        np.testing.assert_allclose(tval, jval, rtol=1e-4)
    for ej, et in zip(epochs_j, epochs_t):
        if ej:      # the rows of an epoch, as multisets
            a, b = np.concatenate(ej), np.concatenate(et)
            np.testing.assert_array_equal(a[np.lexsort(a.T)],
                                          b[np.lexsort(b.T)])


def test_second_epoch_trains_on_the_same_shuffled_data(tmp_path):
    """The reference's own claim for the first case, on the port: the
    second epoch sees the first's shuffled batches and keeps training."""
    out = _run_script(*_drive("port", "recordio_read_train_eof_reset",
                              tmp_path)[:-1])
    runs = [e[1] for e in out if e[0] == "run"]
    first, second = runs[:5], runs[5:]
    losses = [float(r[2].ravel()[0]) for r in runs]
    assert np.isfinite(losses).all()
    assert np.mean(losses[5:]) < np.mean(losses[:5]) + 0.5
    # the same 50 samples, reshuffled (the shuffle's stream runs on)
    rows = [np.sort(np.concatenate([r[0] for r in part]), axis=0)
            for part in (first, second)]
    np.testing.assert_array_equal(rows[0], rows[1])
    assert not all(np.array_equal(a[1], b[1]) for a, b in zip(first, second))


def test_the_port_registers_the_ten_reader_op_types():
    import inspect

    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    import paddle_tpu.ops.reader_ops as jmod

    ops = sorted(op for op in jreg.registered_ops()
                 if inspect.getmodule(jreg._registry[op].lower) is jmod)
    assert len(ops) == 10
    for op in ops:
        assert treg.has_op(op), op
        assert treg.get_op_info(op).host_op, op


def test_prepare_refuses_a_reader_program(tmp_path):
    fluid, main, exe, scope, reader, fetch, _, _ = _drive(
        "port", "batch_reader_drops_partial", tmp_path)
    with pytest.raises(ValueError, match="host op"):
        exe.prepare(main, feed_specs={}, fetch_list=fetch, scope=scope)


def test_reset_without_startup_names_the_reader():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        r = tfluid.layers.io.random_data_generator(
            low=0.0, high=1.0, shapes=[[-1, 2]], lod_levels=[0])
    with pytest.raises(RuntimeError, match="not initialized"):
        r.reset(scope=tfluid.Scope())


def test_reader_descs_are_the_references_bytes():
    """The reader chain and its read op serialize to the JAX package's
    bytes, startup and main."""
    descs = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _mnist_chain(fluid, ["/nonexistent.recordio"])
        descs[pkg] = (main.desc.serialize_to_string(),
                      startup.desc.serialize_to_string())
    assert descs["port"] == descs["jax"]


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_resnet_from_a_recordio_file_equals_the_fed_run(tmp_path, amp):
    """chip_smoke.py's train_reader_k6 at the CPU's size: ResNet depth 8
    on cifar-shaped uint8 images, NHWC with fused stages (under AMP with
    FLAGS_bn_bf16 too), fed by open_files -> shuffle -> batch ->
    double_buffer -> read_file through run(): an epoch, the EOF, reset()
    and one step more.  The read op's batches equal the chain's reader
    classes decoding the file on the host, and the same batches fed
    through run() from the same start give every loss and persistable
    bit for bit."""
    import chip_smoke as cs
    from paddle_tpu_torch.core.flags import FLAGS

    samples = cs.reader_samples(12, 3, shape=(3, 32, 32), classes=10)
    rio = str(tmp_path / "cifar.recordio")
    assert cs.write_reader_file(tfluid, rio, samples) == 12
    kw = dict(data_set="cifar10", depth=8, batch=4, shuffle=8, amp=amp)
    prev = FLAGS.bn_bf16
    FLAGS.bn_bf16 = amp
    try:
        main, startup, loss, reader, image, label = cs.build_reader_resnet(
            tfluid, rio, **kw)
        fmain, fstartup, floss, _, fimage, flabel = cs.build_reader_resnet(
            tfluid, **kw)
        fused = [op.type for op in main.desc.blocks[0].ops
                 if op.type == "fused_conv2d_bn_act"]
        assert len(fused) == 9
        assert main.desc.blocks[0].ops[0].type == "read"
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        init = {k: v.clone() for k, v in
                cs.persistable_tensors(torch, main, scope).items()}
        losses, popped = [], []
        for i in range(4):
            if i == 3:
                with pytest.raises(tfluid.core.EOFException):
                    exe.run(main, fetch_list=[loss], scope=scope)
                reader.reset(scope=scope)
            losses.append(exe.run(main, fetch_list=[loss], scope=scope)[0])
            popped.append([scope.find_var(v.name).numpy()
                           for v in (image, label)])
        host = cs.host_reader_batches(rio, 4, 8, 4, reset_at=3)
        for p, h in zip(popped, host):
            assert p[0].dtype == np.uint8
            np.testing.assert_array_equal(p[0], h[0])
            np.testing.assert_array_equal(p[1], h[1])
        fscope = tfluid.Scope()
        exe.run(fstartup, scope=fscope)
        for k, v in init.items():
            fscope.set(k, v.clone())
        fed = [exe.run(fmain, feed={fimage.name: h[0], flabel.name: h[1]},
                       fetch_list=[floss], scope=fscope)[0] for h in host]
    finally:
        FLAGS.bn_bf16 = prev
    assert [x.tobytes() for x in losses] == [x.tobytes() for x in fed]
    final = cs.persistable_tensors(torch, main, scope)
    fed_final = cs.persistable_tensors(torch, fmain, fscope)
    assert sorted(final) == sorted(fed_final)
    for k in final:
        assert torch.equal(final[k], fed_final[k]), k
