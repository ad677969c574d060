"""The per-platform kernel choice (ops/routes.py) and the compile-cache
location (utils/cache.py)."""

import os

import pytest

from ipmzoo.ops import routes
from ipmzoo.ops.routes import Route, arrow_method, batched_ldlt_route
from ipmzoo.utils import cache

OPS = ("factor", "solve")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("platform,n,expect", [
    ("gpu", 24, Route("pallas")), ("gpu", 32, Route("pallas")),
    ("gpu", 33, Route("xla")), ("gpu", 64, Route("xla")),
    ("cpu", 24, Route("xla"))])
def test_auto_route(platform, n, op, expect, monkeypatch):
    monkeypatch.setattr(routes, "PALLAS_OPS", OPS)
    assert batched_ldlt_route("auto", n, op, platform=platform) == expect


@pytest.mark.parametrize("op", OPS)
def test_auto_route_follows_measured_ops(op, monkeypatch):
    monkeypatch.setattr(routes, "PALLAS_OPS", ("factor",))
    got = batched_ldlt_route("auto", 24, op, platform="gpu")
    assert got.kernel == ("pallas" if op == "factor" else "xla")


@pytest.mark.parametrize("requested", ["auto", "pallas", "pl", "jnp", "xla"])
@pytest.mark.parametrize("op", OPS)
def test_gpu_never_interprets(requested, op):
    assert not batched_ldlt_route(requested, 16, op,
                                  platform="gpu").interpret


@pytest.mark.parametrize("requested", ["pallas", "pl"])
@pytest.mark.parametrize("op", OPS)
def test_explicit_kernel_without_compiled_kernel_raises(requested, op):
    with pytest.raises(ValueError, match="no compiled Pallas kernel"):
        batched_ldlt_route(requested, 16, op, platform="cpu")


@pytest.mark.parametrize("requested", ["auto", "pallas", "pl"])
def test_interpret_only_when_asked(requested):
    assert batched_ldlt_route(requested, 16, interpret=True,
                              platform="cpu") == Route("pallas", True)


def test_plain_request_ignores_interpret():
    assert batched_ldlt_route("jnp", 16, interpret=True,
                              platform="cpu") == Route("xla")


def test_unknown_requests_raise():
    with pytest.raises(ValueError):
        batched_ldlt_route("mosaic", 16, platform="gpu")
    with pytest.raises(ValueError):
        batched_ldlt_route("auto", 16, "inverse", platform="gpu")


@pytest.mark.parametrize("requested,n_blocks,expect", [
    ("auto", 8, "cr"), ("auto", 7, "scan"), ("cr", 2, "cr"),
    ("scan", 64, "scan")])
def test_arrow_method(requested, n_blocks, expect):
    assert arrow_method(requested, n_blocks) == expect


def test_arrow_pallas_method_is_gone():
    with pytest.raises(ValueError):
        arrow_method("pl", 64)


def test_schur_pallas_request_raises_on_cpu():
    from ipmzoo.parallel.schur import SchurIPM
    with pytest.raises(ValueError, match="no compiled Pallas kernel"):
        SchurIPM(4, 2, block_kernel="pallas")


def test_nd_pl_request_raises_on_cpu():
    import jax.numpy as jnp
    import numpy as np
    from ipmzoo.ops.ndiss import nd_factor, nd_plan
    K = np.eye(12) * 4 + np.eye(12, k=1) + np.eye(12, k=-1)
    plan = nd_plan(K != 0, leaf=4)
    with pytest.raises(ValueError, match="no compiled Pallas kernel"):
        nd_factor(jnp.asarray(K), plan, method="pl")


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.compile_cache_dir() == os.path.join(root, ".jax_cache")
    assert cache.compile_cache_dir() == cache.compile_cache_dir()
