"""The port's page quantization against ``repro.core.quantize``: the int8
payload and the f32 scale of ``quantize_page`` are bit-equal to the
reference's on seeded pages (whole, partial-valid, all-zero, and one with
exact .5 ties that round half to even), and ``page_scale`` is bit-equal on
amax tables with zeros. No tolerance: both sides divide in f32 and round
half to even."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantize as jq  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402


def _both(x, valid=None):
    got = tq.quantize_page(torch.from_numpy(x),
                           None if valid is None else torch.from_numpy(valid))
    want = jq.quantize_page(jnp.asarray(x),
                            None if valid is None else jnp.asarray(valid))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _pages():
    rng = np.random.default_rng(13)
    # amax 127 gives scale 1.0 exactly, so x / scale = x lands on the ties
    tie_page = np.zeros((16, 2, 4), np.float32)
    tie_page.flat[:18] = np.arange(-9, 9, dtype=np.float32) + 0.5
    tie_page.flat[18] = 127.0
    return {
        "gaussian": rng.standard_normal((16, 2, 8)).astype(np.float32),
        "wide": (rng.standard_normal((16, 8, 128)) * 40).astype(np.float32),
        "ties": tie_page,
        "zero": np.zeros((16, 1, 16), np.float32),
    }


@pytest.mark.parametrize("name", list(_pages()))
def test_quantize_page_bit_equal(name):
    x = _pages()[name]
    (q, s), (wq, ws) = _both(x)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, wq)
    np.testing.assert_array_equal(s, ws)
    if name == "zero":
        assert s == 1.0 and not q.any()


@pytest.mark.parametrize("n_valid", [0, 1, 7, 16])
def test_quantize_partial_page_bit_equal(n_valid):
    """Rows past the write frontier are out of the amax and stored as 0;
    a page with no valid row gets scale 1.0."""
    rng = np.random.default_rng(14 + n_valid)
    x = (rng.standard_normal((16, 2, 8)) * 5).astype(np.float32)
    x[n_valid:] *= 100.0            # stale rows would dominate the amax
    valid = np.arange(16) < n_valid
    (q, s), (wq, ws) = _both(x, valid)
    np.testing.assert_array_equal(q, wq)
    np.testing.assert_array_equal(s, ws)
    assert not q[n_valid:].any()
    if n_valid == 0:
        assert s == 1.0


def test_page_scale_bit_equal():
    rng = np.random.default_rng(15)
    amax = np.abs(rng.standard_normal((4, 9))).astype(np.float32)
    amax[0, :3] = 0.0
    np.testing.assert_array_equal(
        tq.page_scale(torch.from_numpy(amax)).numpy(),
        np.asarray(jq.page_scale(jnp.asarray(amax))))
