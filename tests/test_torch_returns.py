"""The port's reverse affine scan and GAE against trpo_tpu on the CPU.

The JAX side runs the Pallas scan kernel through the Pallas interpreter
(as ``tests/test_pallas_scan.py`` does) and the XLA associative scan; the
port's wrapper runs its plain version for CPU tensors. Tolerance 2e-5, the
reference's scan tolerance (``tests/test_pallas_scan.py:32``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_tpu.ops.pallas_scan import reverse_affine_scan_pallas
from trpo_tpu.ops import returns as tpu_returns
from trpo_torch.ops import _build
from trpo_torch.ops.returns import (
    discounted_returns_segmented,
    gae_from_next_values,
)
from trpo_torch.ops.reverse_scan import (
    reverse_affine_scan,
    reverse_affine_scan_plain,
)

TOL = 2e-5


@pytest.mark.parametrize("shape", [(5, 3), (16, 128), (33, 300), (1, 1)])
def test_plain_scan_matches_pallas_kernel(shape):
    T, N = shape
    rng = np.random.default_rng(0)
    c = rng.uniform(0, 1, (T, N)).astype(np.float32)
    x = rng.normal(size=(T, N)).astype(np.float32)
    want = reverse_affine_scan_pallas(jnp.asarray(c), jnp.asarray(x),
                                      interpret=True)
    got = reverse_affine_scan_plain(torch.from_numpy(c), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    _build.reset_launches()
    x = torch.randn(7, 4, generator=torch.Generator().manual_seed(0))
    reverse_affine_scan(torch.full_like(x, 0.5), x)
    assert _build.LAUNCHES["reverse_scan_plain"] == 1
    assert _build.LAUNCHES["reverse_scan"] == 0


@pytest.mark.parametrize(
    "bad",
    [
        (torch.zeros(4, 3), torch.zeros(4, 2)),          # shape mismatch
        (torch.zeros(4), torch.zeros(4)),                # not (T, N)
        (torch.zeros(4, 3, dtype=torch.float64),) * 2,   # not f32
    ],
)
def test_scan_rejects_bad_inputs(bad):
    with pytest.raises((ValueError, TypeError)):
        reverse_affine_scan(*bad)


def _episodes(T, N, seed):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    next_values = rng.normal(size=(T, N)).astype(np.float32)
    done = rng.uniform(size=(T, N)) < 0.1
    terminated = done & (rng.uniform(size=(T, N)) < 0.5)
    return rewards, values, next_values, terminated, done


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_gae_matches_reference_backends(backend):
    r, v, nv, term, done = _episodes(40, 130, 1)
    want_adv, want_tgt = tpu_returns.gae_from_next_values(
        *(jnp.asarray(a) for a in (r, v, nv, term, done)), 0.99, 0.95,
        backend=backend,
    )
    adv, tgt = gae_from_next_values(
        *(torch.from_numpy(a) for a in (r, v, nv, term, done)), 0.99, 0.95
    )
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(want_tgt), rtol=TOL,
                               atol=TOL)


def test_discounted_returns_match_reference():
    r, _, _, _, done = _episodes(25, 9, 2)
    want = tpu_returns.discounted_returns_segmented(
        jnp.asarray(r), jnp.asarray(done), 0.97)
    got = discounted_returns_segmented(torch.from_numpy(r),
                                       torch.from_numpy(done), 0.97)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
