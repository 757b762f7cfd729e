"""The port's kernels on the CPU: plain versions against the JAX package,
and the dispatch between plain versions and kernels.

On the CPU the plain PyTorch versions (``repro_torch.kernels.ref``, which
``repro_torch.kernels.ops`` runs for CPU tensors) are held against the JAX
registry (``repro.kernels.ops``, Pallas interpret mode) and the JAX oracles
(``repro.kernels.ref``) on the same numpy inputs, for every output mask and
at ragged shapes (no multiple of 8 or 128).  The card tests (marked ``gpu``)
live in ``tests/test_torch_card.py``, which imports no JAX.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

RTOL = ATOL = 3e-5  # float32 sums in another order (tests/test_differential.py)

FIRST_MASKS = [dict(want_l2=l2, want_moment=mo, want_dot=do)
               for l2, mo, do in itertools.product([False, True], repeat=3)
               if l2 or mo or do]
SECOND_MASKS = [dict(want_diag=d, want_kron=k, want_trace=t)
                for d, k, t in itertools.product([False, True], repeat=3)
                if d or k or t]


def _mask_id(m):
    return "+".join(k[5:] for k, v in m.items() if v)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port, *references):
    for reference in references:
        assert set(port) == set(reference)
        for k in reference:
            want = np.asarray(reference[k])
            # Off-diagonal Gram entries cancel: their rounding error scales
            # with the diagonal ⟨G_n, G_n⟩, not with the entry itself.
            atol = ATOL * max(1.0, np.abs(want).max()) if k == "dot" else ATOL
            np.testing.assert_allclose(port[k].numpy(), want, rtol=RTOL,
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("mask", FIRST_MASKS, ids=_mask_id)
@pytest.mark.parametrize("shape", [(1, 5, 7, 9, 13), (2, 3, 10, 130, 6)],
                         ids=["ragged", "wide_e2"])
def test_fused_first_order_matches_jax(shape, mask):
    e, n, r, a, b = shape
    A, B = _rand(0, e, n, r, a), _rand(1, e, n, r, b)
    port = ops.fused_first_order(torch.from_numpy(A), torch.from_numpy(B), **mask)
    _close(port, jops.fused_first_order(jnp.asarray(A), jnp.asarray(B), **mask),
           jref.fused_first_order(jnp.asarray(A), jnp.asarray(B), **mask))


def test_fused_first_order_three_dim_inputs():
    A, B = _rand(2, 6, 4, 11), _rand(3, 6, 4, 5)
    port = ops.fused_first_order(torch.from_numpy(A), torch.from_numpy(B),
                                 want_l2=True, want_moment=True, want_dot=True)
    _close(port, jops.fused_first_order(jnp.asarray(A), jnp.asarray(B),
                                        want_l2=True, want_moment=True,
                                        want_dot=True))


@pytest.mark.parametrize("mask", SECOND_MASKS, ids=_mask_id)
@pytest.mark.parametrize("shape", [(3, 5, 7, 9, 13), (10, 4, 6, 130, 3)],
                         ids=["ragged", "wide_c10"])
def test_fused_second_order_matches_jax(shape, mask):
    c, n, r, a, b = shape
    A, S = _rand(4, n, r, a), _rand(5, c, n, r, b)
    port = ops.fused_second_order(torch.from_numpy(A), torch.from_numpy(S), **mask)
    _close(port, jops.fused_second_order(jnp.asarray(A), jnp.asarray(S), **mask),
           jref.fused_second_order(jnp.asarray(A), jnp.asarray(S), **mask))


@pytest.mark.parametrize("shape", [(5, 7, 9), (13, 130, 3), (40, 33, 140)],
                         ids=["ragged", "wide_a", "wide_b"])
def test_sq_matmul_matches_jax(shape):
    n, a, b = shape
    A, B = _rand(6, n, a), _rand(7, n, b)
    port = ops.sq_matmul(torch.from_numpy(A), torch.from_numpy(B))
    for reference in (jops.sq_matmul(jnp.asarray(A), jnp.asarray(B)),
                      jref.sq_matmul(jnp.asarray(A), jnp.asarray(B))):
        np.testing.assert_allclose(port.numpy(), np.asarray(reference),
                                   rtol=RTOL, atol=ATOL)


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    ops.reset_launch_counts()
    A, B = torch.randn(4, 3, 5), torch.randn(4, 3, 6)
    ops.fused_first_order(A, B)
    ops.fused_second_order(A, B[None])
    ops.sq_matmul(A[:, 0], B[:, 0])
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_dispatch_refuses_other_devices():
    A = torch.empty(4, 5, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.sq_matmul(A, A)
    with pytest.raises(ValueError, match="several devices"):
        ops.sq_matmul(torch.zeros(4, 5), A)
