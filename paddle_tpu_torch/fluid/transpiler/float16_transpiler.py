"""bf16 mixed-precision transpiler.

Counterpart of ``paddle_tpu/fluid/transpiler/float16_transpiler.py``.
The transpiler rewrites nothing but one program flag,
``program.desc.amp_bf16``; the block lowering (``core/lowering.py``:
``AMP_WHITE`` / ``AMP_BLACK`` and ``amp_cast_ins``) then casts the inputs
of the matrix-product ops to bfloat16 as each op runs, forward and
backward alike.  Parameters stay float32 in the scope (master weights):
autograd through the casts gives float32 parameter gradients, and the
optimizer ops run in float32.  bf16's float32-sized exponent means no
loss scaling.
"""
from __future__ import annotations

__all__ = ["Float16Transpiler"]


class Float16Transpiler:
    """Enable bf16 mixed precision on a program (training or inference),
    before or after ``optimizer.minimize``::

        fluid.transpiler.Float16Transpiler().transpile(main_program)
    """

    def transpile(self, program, place=None, scope=None):
        # place and scope are taken for the reference API's signature;
        # no weight copies are made, so neither is used
        program.desc.amp_bf16 = True
        program.desc.bump_version()

    def revert(self, program):
        """Back to float32 (there are no weight copies to undo)."""
        program.desc.amp_bf16 = False
        program.desc.bump_version()
