"""A bfloat16 persistable survives ``save_persistables`` /
``load_persistables`` between the two packages: port→port, JAX→port and
port→JAX, on the CPU.

The JAX package writes a bfloat16 array into ``params.npz`` as 2-byte
records, which ``np.load`` returns as dtype ``|V2`` (and the JAX loader
hands back as it is, ROADMAP.md "Reference caveats").  So the files are
compared by the bytes of each member's payload, and a value that comes
back into the port is compared bit for bit as int16."""

import os

import numpy as np
import pytest
import torch

import ml_dtypes

import paddle_tpu.fluid as jfluid
from paddle_tpu import io as jio
from paddle_tpu.framework import core as jcore

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import core as tcore

VARS = (("w_bf16", (3, 4), "bfloat16"), ("b_f32", (5,), "float32"),
        ("steps", (1,), "int64"))


def _values():
    rng = np.random.default_rng(6)
    return {"w_bf16": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
            "b_f32": rng.standard_normal(5).astype(np.float32),
            "steps": np.array([7], dtype=np.int64)}


def _program(core):
    main = core.Program()
    for name, shape, dtype in VARS:
        main.global_block().create_var(name=name, shape=list(shape),
                                       dtype=dtype, persistable=True)
    return main


def _payloads(path):
    """Each npz member's array bytes, and its dtype as np.load gives it."""
    with np.load(path) as data:
        return {n: (data[n].tobytes(), data[n].dtype.str)
                for n in data.files}


def _port_save(dirname, values):
    scope = tfluid.Scope()
    for name, a in values.items():
        scope.set_var(name, tio.convert_params({name: a}, "cpu")[name])
    tio.save_persistables(tfluid.Executor(tfluid.CPUPlace()), dirname,
                          _program(tcore), scope=scope)


def _port_load(dirname):
    scope = tfluid.Scope()
    tio.load_persistables(tfluid.Executor(tfluid.CPUPlace()), dirname,
                          _program(tcore), scope=scope)
    return {name: scope.find_var(name) for name, _, _ in VARS}


def _jax_save(dirname, values):
    scope = jfluid.Scope()
    for name, a in values.items():
        scope.set_var(name, a)
    jio.save_persistables(None, dirname, _program(jcore), scope=scope)


def _jax_load(dirname):
    scope = jfluid.Scope()
    jio.load_persistables(None, dirname, _program(jcore), scope=scope)
    return {name: np.asarray(scope.find_var(name)) for name, _, _ in VARS}


def _assert_port_values(got, values):
    bf = got["w_bf16"]
    assert bf.dtype == torch.bfloat16 and tuple(bf.shape) == (3, 4)
    np.testing.assert_array_equal(bf.view(torch.int16).numpy(),
                                  values["w_bf16"].view(np.int16))
    assert got["b_f32"].dtype == torch.float32
    np.testing.assert_array_equal(got["b_f32"].numpy(), values["b_f32"])
    assert got["steps"].dtype == torch.int64
    np.testing.assert_array_equal(got["steps"].numpy(), values["steps"])


def test_port_to_port(tmp_path):
    values = _values()
    _port_save(str(tmp_path), values)
    files = _payloads(os.path.join(tmp_path, "params.npz"))
    assert files["w_bf16"][1] == "|V2"          # 2-byte records, not float32
    _assert_port_values(_port_load(str(tmp_path)), values)


def test_jax_to_port(tmp_path):
    values = _values()
    _jax_save(str(tmp_path), values)
    _assert_port_values(_port_load(str(tmp_path)), values)


def test_port_to_jax(tmp_path):
    values = _values()
    _port_save(str(tmp_path / "port"), values)
    _jax_save(str(tmp_path / "jax"), values)
    port = _payloads(os.path.join(tmp_path, "port", "params.npz"))
    ref = _payloads(os.path.join(tmp_path, "jax", "params.npz"))
    assert port == ref
    got = _jax_load(str(tmp_path / "port"))
    np.testing.assert_array_equal(got["w_bf16"].view(np.int16),
                                  values["w_bf16"].view(np.int16))
    np.testing.assert_array_equal(got["b_f32"], values["b_f32"])
    np.testing.assert_array_equal(got["steps"], values["steps"])


def test_two_byte_records_need_a_bfloat16_var():
    records = np.zeros(3, dtype=np.int16).view("V2")
    with pytest.raises(TypeError, match="2-byte record"):
        tio.convert_params({"x": records}, "cpu", {"x": "float16"})
    t = tio.convert_params({"x": records}, "cpu", {"x": "bfloat16"})["x"]
    assert t.dtype == torch.bfloat16
