"""The port's ``Config`` against ``cfd_tpu.config.Config``.

For the same arguments, and for the same ``CFD_*`` environment, both
build the same fields or raise the same error, and their schemes have
equal tables (gate 1: the float64 LHS bands and RHS matrix). The JAX
method ``"pallas"`` is the port's ``"kernel"``; the methods both take are
held to the same answers. ``make_grid`` lays the port's mesh over a list
of devices (``["cpu"] * 8`` here).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cfd_tpu.config import Config as JaxConfig
from cfd_tpu_torch.config import Config
from cfd_tpu_torch.schemes import lhs_bands, rhs_matrix

SHARED_METHODS = ("auto", "matmul", "pcr", "thomas", "phipsi")


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


def _same_scheme(ours, theirs, n=32):
    from cfd_tpu.schemes import lhs_bands as jlhs, rhs_matrix as jrhs

    for a, b in zip(lhs_bands(ours, n), jlhs(theirs, n)):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(rhs_matrix(ours, n), np.asarray(jrhs(theirs, n)))


def test_fields_and_defaults_match():
    assert [f.name for f in dataclasses.fields(Config)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    assert _fields(Config()) == _fields(JaxConfig())
    assert Config().torch_dtype == torch.float32


@pytest.mark.parametrize("kw", [
    dict(order=6, periodic=True),
    dict(order=4, periodic=False, dtype="float64", method="pcr"),
    dict(dtype="bfloat16", method="matmul", mesh_shape=(1, 2, 4), grid_shape=(32, 64, 128)),
    *(dict(method=m) for m in SHARED_METHODS),
])
def test_same_arguments_same_config_and_scheme(kw):
    ours, theirs = Config(**kw), JaxConfig(**kw)
    assert _fields(ours) == _fields(theirs)
    _same_scheme(ours.scheme, theirs.scheme)
    assert str(ours.torch_dtype).split(".")[-1] == theirs.jax_dtype.__name__


@pytest.mark.parametrize("kw", [
    dict(dtype="float16"),
    dict(method="magic"),
    dict(order=8),
    dict(order=5, periodic=True),
])
def test_same_validation_errors(kw):
    with pytest.raises(ValueError) as ours:
        Config(**kw)
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**kw)
    assert str(ours.value).split(";")[0] == str(theirs.value).split(";")[0]


def test_kernel_is_pallas():
    """float64 takes no kernel route, in either package."""
    with pytest.raises(ValueError, match="float64 requires"):
        Config(dtype="float64", method="kernel")
    with pytest.raises(ValueError, match="float64 requires"):
        JaxConfig(dtype="float64", method="pallas")
    with pytest.raises(ValueError, match="bad method"):
        Config(method="pallas")


@pytest.mark.parametrize("env", [
    {"CFD_ORDER": "6", "CFD_PERIODIC": "true", "CFD_MESH": "1,2,4", "CFD_GRID": "32,64,128"},
    {"CFD_SPACING": "0.1,0.2,0.3", "CFD_DTYPE": "float64", "CFD_METHOD": "pcr"},
    {"CFD_SPACING": "0.05", "CFD_PERIODIC": "1", "CFD_METHOD": "phipsi"},
])
def test_from_env_matches(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _fields(Config.from_env()) == _fields(JaxConfig.from_env())
    assert _fields(Config.from_env(method="matmul")) == \
        _fields(JaxConfig.from_env(method="matmul"))


def test_from_env_same_error(monkeypatch):
    monkeypatch.setenv("CFD_DTYPE", "int8")
    with pytest.raises(ValueError, match="bad dtype int8"):
        Config.from_env()
    with pytest.raises(ValueError, match="bad dtype int8"):
        JaxConfig.from_env()


def test_make_grid_over_devices():
    c = Config(mesh_shape=(2, 2, 2), grid_shape=(16, 16, 16), method="pcr")
    g = c.make_grid(["cpu"] * 8)
    assert g.local_shape == (8, 8, 8) == JaxConfig(**_fields(c)).make_grid().local_shape
    assert g.scheme is c.scheme
    with pytest.raises(ValueError, match="needs 8 devices"):
        c.make_grid(["cpu"] * 4)
