"""What ``cast``, ``squeeze2`` and ``split`` accept and refuse: each case
runs through the JAX package's op and the port's op on the CPU, and both
give the same result (values, shapes and dtypes) or raise the same
exception class."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid  # noqa: F401  (registers the JAX package's ops)
from paddle_tpu.ops.registry import get_op as jget_op

from paddle_tpu_torch.ops import registry as tregistry

CASES = [
    # cast: out_dtype, else dtype, else float32
    ("cast", (2, 3), {"out_dtype": "int32"}),
    ("cast", (2, 3), {"dtype": "int32"}),
    ("cast", (2, 3), {"dtype": "float16"}),
    ("cast", (2, 3), {"dtype": "bfloat16"}),
    ("cast", (2, 3), {"out_dtype": "float16", "dtype": "int32"}),
    ("cast", (2, 3), {}),
    # squeeze2: size-1 axes only
    ("squeeze2", (2, 1, 3, 1), {"axes": [1]}),
    ("squeeze2", (2, 1, 3, 1), {"axes": [-1, 1]}),
    ("squeeze2", (2, 1, 3, 1), {}),
    ("squeeze2", (2, 1, 3, 1), {"axes": [0]}),
    ("squeeze2", (2, 1, 3, 1), {"axes": [1, 2]}),
    # split: by an even num, or by sections
    ("split", (4, 6), {"num": 3, "axis": 1}),
    ("split", (4, 6), {"num": 4, "axis": 1}),
    ("split", (4, 6), {"num": 0, "axis": 1}),
    ("split", (4, 6), {"num": 2, "axis": -2}),
    ("split", (4, 6), {"sections": [1, 2, 3], "axis": 1}),
    ("split", (4, 6), {"sections": [2, -1], "axis": 1}),
    ("split", (4, 6), {"sections": [4], "axis": 0}),
]


def _run(fn, a):
    try:
        return fn(a), None
    except Exception as e:          # the class is what is compared
        return None, type(e)


@pytest.mark.parametrize("op,shape,attrs", CASES,
                         ids=[f"{op}-{i}" for i, (op, _, _) in
                              enumerate(CASES)])
def test_port_op_matches_the_jax_op(op, shape, attrs):
    a = (np.arange(np.prod(shape), dtype=np.float32) * 0.37 - 1.5
         ).reshape(shape)
    ref, ref_exc = _run(lambda v: jget_op(op)(None, {"X": [v]},
                                                 dict(attrs)), a)
    got, got_exc = _run(lambda v: tregistry.get_op(op)(
        tregistry.LoweringContext(), {"X": [torch.from_numpy(v)]},
        dict(attrs)), a)
    assert got_exc is ref_exc, (got_exc, ref_exc)
    if ref_exc is not None:
        return
    refs, gots = ref["Out"], got["Out"]
    if not isinstance(refs, list):
        refs, gots = [refs], [gots]
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        r = np.asarray(r)
        assert str(g.dtype).replace("torch.", "") == r.dtype.name
        assert tuple(g.shape) == r.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      r.astype(np.float32))
