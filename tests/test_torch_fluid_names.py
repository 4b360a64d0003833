"""The port's ``fluid`` names against the JAX package's, on the CPU.

Every name of the reference's ``fluid.__all__`` is in the port's but
those ROADMAP leaves to later items or keeps as a deliberate difference
(``LATER``); every name of the reference's ``fluid`` the issue of the
front-end names listed exists; ``default_scope_funcs`` and
``debugger`` give the reference's results on the same program;
``core`` is the port's executor core (``fluid.core.EOFException``).
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

# reference names the port does not export yet, each with its reason
LATER = {
    # fluid/profiler.py imports the observability package: it goes with
    # ROADMAP queue 1 item 11's observability copy
    "profiler": "item 11",
    # the eager executor has no build or execution knobs: item 10 ports
    # them with their first caller
    "ExecutionStrategy": "item 10",
    "BuildStrategy": "item 10",
    # the port's accelerator place is CUDAPlace (core/place.py)
    "TPUPlace": "CUDAPlace",
}
NAMES = ("default_scope_funcs", "debugger", "is_compiled_with_cuda",
         "is_compiled_with_tpu", "Tensor", "core", "FLAGS", "define_flag",
         "PreparedProgram", "recordio_writer")


def test_every_reference_name_but_the_later_ones():
    want = set(jfluid.__all__)
    assert set(LATER) <= want
    missing = sorted(want - set(tfluid.__all__))
    assert missing == sorted(LATER), missing
    for name in want - set(LATER):
        assert hasattr(tfluid, name), name


@pytest.mark.parametrize("name", NAMES)
def test_front_end_name_exists(name):
    assert hasattr(jfluid, name) and hasattr(tfluid, name)


def test_core_is_the_port_executor_core():
    from paddle_tpu_torch.core import executor_impl

    assert tfluid.core is executor_impl
    assert issubclass(tfluid.core.EOFException, Exception)
    assert tfluid.PreparedProgram.__module__ == "paddle_tpu_torch.fluid." \
        "executor"
    assert tfluid.Tensor is None and jfluid.Tensor is None


def test_is_compiled_with_cuda_reads_the_torch_build():
    import torch

    assert tfluid.is_compiled_with_cuda() is (torch.version.cuda is not None)
    assert tfluid.is_compiled_with_tpu() is False
    assert jfluid.is_compiled_with_cuda() is False


def test_flags_and_define_flag():
    from paddle_tpu_torch.core import flags

    assert tfluid.FLAGS is flags.FLAGS
    with pytest.raises(AttributeError):
        tfluid.FLAGS.not_a_flag
    tfluid.define_flag("custom_port_test_flag", 7)
    assert tfluid.FLAGS.custom_port_test_flag == 7


def test_default_scope_funcs_as_the_reference():
    """The reference's test_fluid_parity_modules case, run in both."""
    results = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        dsf = fluid.default_scope_funcs
        base = dsf.get_cur_scope()
        dsf.enter_local_scope()
        inner = dsf.get_cur_scope()
        assert inner is not base and inner.parent is base
        inner.set("x", 42)
        assert dsf.var("y") is None
        got = (int(np.asarray(dsf.find_var("x"))),
               dsf.scoped_function(lambda: 7))
        dsf.leave_local_scope()
        assert dsf.get_cur_scope() is base
        with pytest.raises(RuntimeError, match="global scope"):
            dsf.leave_local_scope()
        results[pkg] = got
    assert results["port"] == results["jax"] == (42, 7)


def _nan_model(fluid):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    h = fluid.layers.fc(x, size=3, act="relu")
    return fluid.layers.mean(fluid.layers.log(h))


def test_debugger_dumps_equal_the_references():
    text, dot = {}, {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = _nan_model(fluid)
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        text[pkg] = fluid.debugger.pprint_program(main)
        dot[pkg] = fluid.debugger.draw_block_graphviz(
            main.global_block(), highlights=[loss.name])
    assert text["port"] == text["jax"]
    assert dot["port"] == dot["jax"]
    assert "mul(" in text["port"] and "block_0" in text["port"]
    assert dot["port"].startswith("digraph G {")
    assert 'fillcolor="lightgrey"' in dot["port"]
