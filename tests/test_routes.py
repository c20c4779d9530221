"""Route choice on a GPU target, checked on the CPU by pretending the trace
targets a GPU (ops._target_platform patched to "gpu").  Each case traces
the public entry point, looks at which primitives the route put in the
program, and checks that nothing pulls in a module of the removed
double-single family."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asvgp.banded import ops

REMOVED = ("ds", "dsx", "block_ds", "pallas_ds", "pallas_ds_pair",
           "pallas_ds_core", "pallas_ds_tan", "pallas_ds_twist",
           "pallas_ds_block", "pallas_kernels")


def _no_removed_modules():
    loaded = [f"asvgp.banded.{n}" for n in REMOVED
              if f"asvgp.banded.{n}" in sys.modules]
    assert not loaded, loaded


def _primitives(jaxpr, shapes_of=None):
    """Primitive names in a closed jaxpr and its sub-jaxprs (not kernel
    bodies); with ``shapes_of``, the output shapes of that primitive."""
    out = set()
    shapes = set()

    def visit(jx):
        for eqn in jx.eqns:
            out.add(eqn.primitive.name)
            if eqn.primitive.name == shapes_of:
                shapes.update(tuple(v.aval.shape) for v in eqn.outvars)
            if eqn.primitive.name == "pallas_call":
                continue  # the kernel body is not part of the XLA program
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if hasattr(sub, "jaxpr"):
                        visit(getattr(sub.jaxpr, "jaxpr", sub.jaxpr))
                    elif type(sub).__name__ == "Jaxpr":
                        visit(sub)

    visit(jaxpr.jaxpr)
    return shapes if shapes_of else out


@pytest.fixture
def on_gpu(monkeypatch):
    """Trace as if for a GPU, with the GPU's "auto" route set by the test."""
    monkeypatch.setattr(ops, "_target_platform", lambda: "gpu")

    def set_route(route):
        monkeypatch.setattr(ops, "GPU_IMPL", route)

    return set_route


def _gpr1d(m=24):
    from asvgp.basis import B3Spline
    from asvgp.models import GPR1D, Matern32

    rng = np.random.RandomState(0)
    x = rng.uniform(0.02, 0.98, 300)
    y = np.sin(7 * x) + 0.1 * rng.randn(300)
    return GPR1D((x, y), Matern32(lengthscales=0.2), B3Spline(0.0, 1.0, m))


# (route, primitive that must appear, primitive that must not)
CASES = [("scan", "scan", "pallas_call"),
         ("cr", "scan", "pallas_call"),
         ("sweep", "pallas_call", "scan")]


@pytest.mark.parametrize("route,present,absent", CASES)
def test_gpu_route_collapsed_core(on_gpu, route, present, absent):
    on_gpu(route)
    assert ops._route() == route
    model = _gpr1d()
    p = model.init_params()
    prims = _primitives(
        jax.make_jaxpr(jax.value_and_grad(model.training_loss))(p)
    )
    assert present in prims and absent not in prims, sorted(prims)
    if route == "cr":
        # CR is log depth: no sqrt chain of length m, a batched k×k one
        assert "sqrt" in prims
    _no_removed_modules()


@pytest.mark.parametrize("route,present,absent", CASES)
def test_gpu_route_posterior(on_gpu, route, present, absent):
    from asvgp.banded import banded_posterior

    on_gpu(route)
    model = _gpr1d()
    kuu = model.stats.kufkfu_band * 0.0 + jnp.asarray(
        [[4.0]] + [[0.5]] * model.basis.order)
    p = kuu + model.stats.kufkfu_band
    # a fresh function: the route is chosen while tracing, and a cached
    # trace of another route must not be reused
    prims = _primitives(
        jax.make_jaxpr(lambda *a: banded_posterior(*a))(
            kuu, p, model.stats.kuf_y)
    )
    assert present in prims and absent not in prims, sorted(prims)
    _no_removed_modules()


def test_cpu_auto_route_is_scan():
    assert ops._target_platform() == "cpu"
    assert ops._route() == "scan"
    with ops.impl_scope("cr"):
        assert ops._route() == "cr"


@pytest.mark.parametrize("name", ["pallas", "pallas_ds", "nope"])
def test_removed_backend_names_rejected(name):
    with pytest.raises(ValueError):
        ops.impl_scope(name)
    with pytest.raises(ValueError):
        ops.set_impl(name)


def test_gpu_route_block_ops(on_gpu):
    """The Kronecker coupling's block-banded ops are plain batched XLA on a
    GPU target: Cholesky, solves and Takahashi match the dense f64 path."""
    from asvgp.banded import block

    on_gpu("sweep")
    rng = np.random.RandomState(2)
    W, nb, B = 2, 5, 4
    n = nb * B
    A = rng.randn(n, n) / np.sqrt(n)
    dense = A @ A.T + n * np.eye(n)
    mask = np.abs(np.arange(n)[:, None] // B - np.arange(n)[None] // B) <= W
    dense = np.where(mask, dense, 0.0)
    blocks = block.dense_to_block_band(jnp.asarray(dense), W, B)
    rhs = rng.randn(n)

    def run(bl, r):
        L = block.cholesky_block_banded(bl)
        return (block.log_det_from_block_cholesky(L),
                block.cholesky_solve_block_banded(L, r),
                block.block_band_to_dense(
                    block.takahashi_inverse_block_banded(L)))

    prims = _primitives(jax.make_jaxpr(run)(blocks, jnp.asarray(rhs)))
    assert "cholesky" in prims and "pallas_call" not in prims
    ld, x, sinv = run(blocks, jnp.asarray(rhs))
    np.testing.assert_allclose(float(ld), np.linalg.slogdet(dense)[1],
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(dense, rhs),
                               rtol=1e-10)
    inv = np.linalg.inv(dense)
    np.testing.assert_allclose(np.asarray(sinv)[mask], inv[mask],
                               rtol=1e-9, atol=1e-12)
    _no_removed_modules()


def test_gpu_route_additive_coupling(on_gpu):
    """The additive model's dense M×M coupling is one plain f64 Cholesky
    on a GPU target (no padding to panels)."""
    from asvgp.basis import B3Spline
    from asvgp.models import Matern32
    from asvgp.models.additive import GPRAdditive

    rng = np.random.RandomState(4)
    X = rng.uniform(0.05, 0.95, (200, 2))
    y = np.sin(4 * X[:, 0]) + np.cos(3 * X[:, 1]) + 0.1 * rng.randn(200)
    model = GPRAdditive((X, y), [Matern32(lengthscales=0.3)] * 2,
                        [B3Spline(0.0, 1.0, 14)] * 2, noise_variance=0.1)
    p = model.init_params()
    ref = float(model.training_loss(p))
    on_gpu("scan")
    jaxpr = jax.make_jaxpr(model.training_loss)(p)
    prims = _primitives(jaxpr)
    assert "cholesky" in prims and "pallas_call" not in prims
    # one dense Cholesky of the whole M×M coupling, M = 2 × 14
    assert _primitives(jaxpr, "cholesky") == {(28, 28)}
    np.testing.assert_allclose(float(model.training_loss(p)), ref,
                               rtol=1e-13)
    _no_removed_modules()
