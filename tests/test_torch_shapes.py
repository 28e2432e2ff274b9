"""The port's cell shapes (``repro_torch.launch.shapes``) against the JAX
package's (``repro.launch.shapes``), field by field: every ``ShapeSpec``
and ``LONG_OK``, and for the 10 architectures x 4 shapes x single-pod
and multi-pod, ``cell_is_runnable``, ``adjust_config`` (every config
field; the types by name), ``cell_rules`` (also at a data axis of 256,
where the decode batch is too small to shard) and ``batch_input_specs``
(shapes, and types by name).
"""
import dataclasses

import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import shapes as TS  # noqa: E402
from repro_torch.models.common import TensorSpec  # noqa: E402


def _same_type(port, ref) -> bool:
    return str(port).removeprefix("torch.") == jnp.dtype(ref).name


def test_shape_table_and_long_ok():
    assert list(TS.SHAPES) == list(JS.SHAPES)
    for name, want in JS.SHAPES.items():
        assert dataclasses.asdict(TS.SHAPES[name]) == \
            dataclasses.asdict(want)
    assert TS.LONG_OK == JS.LONG_OK


@pytest.mark.parametrize("shape", list(JS.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_jax(arch, shape):
    assert TS.cell_is_runnable(arch, shape) == JS.cell_is_runnable(arch,
                                                                   shape)
    tshape, jshape = TS.SHAPES[shape], JS.SHAPES[shape]
    got = TS.adjust_config(get_config(arch), tshape)
    want = JS.adjust_config(jget_config(arch), jshape)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("dtype", "cache_dtype"):
            assert (g is None) == (w is None) and (
                g is None or _same_type(g, w)), f.name
        else:
            assert g == w, f.name
    for pods in (False, True):
        for data in (16, 256):
            assert TS.cell_rules(tshape, pods, data) == \
                JS.cell_rules(jshape, pods, data)
    specs = TS.batch_input_specs(got, tshape)
    jspecs = JS.batch_input_specs(want, jshape)
    assert list(specs) == list(jspecs)
    for key, spec in specs.items():
        assert isinstance(spec, TensorSpec)
        assert spec.shape == jspecs[key].shape, key
        assert _same_type(spec.dtype, jspecs[key].dtype), key
