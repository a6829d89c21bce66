"""LayerHelper — shared param/var creation logic for layer functions
(ref: python/paddle/fluid/layer_helper.py) — the port of
paddle_tpu/framework/layer_helper.py.

Parameters are declared in the main program AND given an init op in the
startup program, mirroring the reference's two-program contract."""

from __future__ import annotations

from typing import Optional

from . import unique_name
from .core import default_main_program, default_startup_program
from .initializer import XavierInitializer, ConstantInitializer, Initializer


class ParamAttr:
    """ref: python/paddle/fluid/param_attr.py"""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype="float32",
                         is_bias=False, default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        # declare in the main program …
        p = self.block.create_parameter(
            name=name, shape=shape, dtype=dtype, initializer=init,
            regularizer=attr.regularizer, trainable=attr.trainable,
            need_clip=attr.need_clip)
        p.optimize_attrs["learning_rate"] = attr.learning_rate
        # … and emit the init op + declaration into the startup program
        sb = self.startup_program.global_block()
        sp = sb.create_parameter(name=name, shape=shape, dtype=dtype,
                                 initializer=init, trainable=attr.trainable)
        init(sp, sb)
        return p

    def create_variable_for_type_inference(self, dtype="float32", shape=(),
                                           stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            shape=shape, dtype=dtype, stop_gradient=stop_gradient)

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_activation(self, out_var, act: Optional[str]):
        if act is None:
            return out_var
        act_out = self.create_variable_for_type_inference(out_var.dtype,
                                                          out_var.shape)
        self.append_op(type=act, inputs={"X": [out_var]},
                       outputs={"Out": [act_out]})
        return act_out
