"""The port's grouped-capacity mixture of experts (``layers.moe``) against
``repro.models.layers.moe`` on the same seeded weights and tokens, at T =
8, 64, 256 and 384 tokens (G = 1, 1, 2 and 3 dispatch groups of at most
128), in two shapes: 8 experts, top 2, capacity factor 1.0 (capacity at
the mean load, so it binds) and dbrx's 16 experts, top 4, factor 1.25
(at T = 8, a decode tick of 8 slots, 3 choices per expert for 32).

The output and the two aux losses are allclose at rtol 1e-4, atol 1e-5;
the kept mask (which (token, k) choices found room in their expert) is
equal. The reference keeps its mask inside ``moe``; it is read off the
one ``jnp.where`` there that applies it. The port's is read from
``layers.MOE_TRACE``."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jL  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = {"e8k2": dict(d_model=32, d_ff=48, num_experts=8, top_k=2,
                       capacity_factor=1.0),
          "dbrx": dict(d_model=32, d_ff=48, num_experts=16, top_k=4,
                       capacity_factor=1.25)}
# T -> the (B, S) the tokens arrive in
BATCHES = {8: (8, 1), 64: (4, 16), 256: (2, 128), 384: (3, 128)}


class _WhereSpy:
    """``jax.numpy`` with ``where`` recording its condition: inside
    ``repro``'s ``moe`` the one call is ``jnp.where(keep, gate_g, 0.0)``."""

    def __init__(self):
        self.conds = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, cond, *args):
        self.conds.append(np.asarray(cond))
        return jnp.where(cond, *args)


@pytest.mark.parametrize("T", sorted(BATCHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_matches_reference(monkeypatch, shape, T):
    jdims = jL.MoEDims(**SHAPES[shape])
    tdims = tL.MoEDims(**dataclasses.asdict(jdims))
    params = jax.tree.map(np.array,
                          jL.moe_init(jax.random.PRNGKey(T), jdims))
    B, S = BATCHES[T]
    x = np.random.default_rng(T).normal(
        0, 1, (B, S, jdims.d_model)).astype(np.float32)

    spy = _WhereSpy()
    monkeypatch.setattr(jL, "jnp", spy)
    jout, jaux = jL.moe({k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x), jdims)
    monkeypatch.undo()
    assert len(spy.conds) == 1
    trace = []
    monkeypatch.setattr(tL, "MOE_TRACE", trace)
    tout, taux = tL.moe({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), tdims)

    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]),
                                   **TOL)
    (got,) = trace
    G = max(1, T // jdims.group_size)
    cap = max(1, math.ceil(T // G * jdims.top_k / jdims.num_experts
                           * jdims.capacity_factor))
    assert got["cap"] == cap
    want = spy.conds[0].reshape(T, jdims.top_k)
    np.testing.assert_array_equal(got["kept"].numpy(), want)
    assert not want.all(), "capacity did not bind"
    # a dropped choice contributes nothing: with every gate of a token
    # dropped, its output row is exactly zero in both packages
    none = ~want.any(axis=1)
    assert np.all(tout.reshape(T, -1).numpy()[none] == 0)
