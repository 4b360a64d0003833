"""ParamAttr (counterpart of paddle_tpu/fluid/param_attr.py)."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None, sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        # per-dim mesh-axis placement, e.g. (None, "tp"); recorded in the
        # desc, no mesh of the port consumes it yet
        self.sharding = sharding

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        # bool before the numeric branch: isinstance(False, int) is True,
        # and bias_attr=False means "no parameter at all"
        if arg is False:
            return False
        if arg is True:
            return ParamAttr()
        if isinstance(arg, (int, float)):
            return ParamAttr(learning_rate=float(arg))
        from .initializer import Initializer
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError("cannot convert %r to ParamAttr" % (arg,))

    def _to_kwargs(self, with_initializer=False):
        """Constructor-compatible kwargs: ParamAttr(**attr._to_kwargs())
        replicates the attr (used when one param_attr covers several inputs)."""
        kwargs = {
            "name": self.name,
            "learning_rate": self.learning_rate,
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip": self.gradient_clip,
            "do_model_average": self.do_model_average,
            "sharding": self.sharding,
        }
        if with_initializer:
            kwargs["initializer"] = self.initializer
        return kwargs

    def _to_param_kwargs(self):
        """kwargs for Block.create_parameter (Parameter ctor fields)."""
        return {
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
        }
