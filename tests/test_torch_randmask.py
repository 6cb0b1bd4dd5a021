"""The port's random mask (erlamsa_tpu_torch/ops/randmask.py) against the
JAX package's Pallas mask kernels, pallas_randmask and randmask_single,
run in interpret mode on the CPU as tests/test_pallas.py runs them.

Equality is exact (bytes). The CUDA kernel is held to the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erlamsa_tpu.ops.pallas_kernels import pallas_randmask, randmask_single
from erlamsa_tpu_torch.ops import randmask as rm

_single = jax.jit(jax.vmap(randmask_single))


def _inputs(seed, B, L):
    """Seeded params over every op (3 and 4 replace), probabilities 0-101
    (1 fires on a nonzero draw), spans before, across and past the row,
    rows both active and not."""
    rng = np.random.default_rng(seed)
    params = np.stack([
        rng.integers(-L // 4, L, B), rng.integers(-2, L + 8, B),
        rng.integers(0, 5, B), rng.integers(0, 102, B),
        rng.integers(0, 3, B)], 1).astype(np.int32)
    params[:4, 3] = [0, 1, 100, 101]
    params[:4, 4] = 1
    data = rng.integers(0, 256, (B, L), dtype=np.uint8)
    return rng, params, data


@pytest.mark.parametrize("L", [256, 700])
def test_randmask_equals_pallas_randmask(L):
    rng, params, data = _inputs(L, 24, L)
    seeds = rng.integers(-2**31, 2**31, 24).astype(np.int32)
    seeds[:3] = [0, 1, -1]
    ref = np.asarray(pallas_randmask(jnp.asarray(seeds), jnp.asarray(params),
                                     jnp.asarray(data)))
    got = rm.randmask(torch.from_numpy(seeds), torch.from_numpy(params),
                      torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != data).any()


def test_randmask_single_equals_pallas_kernel():
    rng, params, data = _inputs(9, 16, 300)
    kd = rng.integers(0, 2**32, (16, 2), dtype=np.uint64).astype(np.uint32)
    keys = jax.vmap(jax.random.wrap_key_data)(jnp.asarray(kd))
    ref = np.asarray(_single(keys, jnp.asarray(params), jnp.asarray(data)))
    kt = torch.from_numpy(kd.astype(np.int64))
    for b in range(16):
        got = rm.randmask_single(kt[b], torch.from_numpy(params[b]),
                                 torch.from_numpy(data[b]))
        np.testing.assert_array_equal(got.numpy(), ref[b])


# (s, l) whose int32 span end s + l wraps, or sits at its edges: the end
# wraps negative (nothing masked), wraps to a large positive (everything
# from 0), l = 0, l < 0, s + l exactly 2^31 - 1 (no wrap) and one past it
_WRAP_SPANS = ((5, 2**31 - 2), (-2**31 + 5, -10), (7, 0), (40, -3),
               (3, 2**31 - 4), (4, 2**31 - 4))


@pytest.mark.parametrize("entry", ["randmask", "randmask_single"])
def test_span_end_wraps_like_int32(entry):
    L = 64
    rng = np.random.default_rng(5)
    params = np.asarray([[s, l, op, 100, 1] for s, l in _WRAP_SPANS
                         for op in (2, 3)], np.int32)
    B = len(params)
    data = rng.integers(0, 256, (B, L), dtype=np.uint8)
    seeds = np.arange(1, B + 1, dtype=np.int32)
    if entry == "randmask":
        ref = np.asarray(pallas_randmask(jnp.asarray(seeds),
                                         jnp.asarray(params),
                                         jnp.asarray(data)))
        got = rm.randmask(torch.from_numpy(seeds), torch.from_numpy(params),
                          torch.from_numpy(data)).numpy()
    else:
        keys = jax.vmap(jax.random.key)(jnp.asarray(seeds))
        ref = np.asarray(_single(keys, jnp.asarray(params),
                                 jnp.asarray(data)))
        kt = rm.seed_keys(torch.from_numpy(seeds))
        got = np.stack([rm.randmask_single(kt[b], torch.from_numpy(params[b]),
                                           torch.from_numpy(data[b])).numpy()
                        for b in range(B)])
    np.testing.assert_array_equal(got, ref)
    changed = (ref != data).sum(1)
    # the first span's end wraps negative, the second's to a large positive
    assert changed[0] == 0 and changed[2] > L // 2
    assert changed[8] > 0 and changed[10] == 0


def test_seed_keys_are_jax_keys():
    seeds = np.asarray([0, 1, 7, -1, 2**31 - 1, -(2**31)], np.int32)
    ref = np.asarray(jax.vmap(lambda s: jax.random.key_data(
        jax.random.key(s)))(jnp.asarray(seeds)))
    got = rm.seed_keys(torch.from_numpy(seeds))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_wrapper_checks_operands_and_counts_no_cpu_launch():
    data = torch.zeros(2, 64, dtype=torch.uint8)
    params = torch.tensor([[0, 64, 3, 100, 1], [0, 64, 3, 100, 0]],
                          dtype=torch.int32)
    before = rm.launches
    out = rm.randmask(torch.tensor([5, 6], dtype=torch.int32), params, data)
    assert rm.launches == before
    assert (out[1] == 0).all() and (out[0] != 0).any()
    with pytest.raises(ValueError, match="params"):
        rm.randmask(torch.tensor([5, 6]), params.long(), data)
    with pytest.raises(ValueError, match="seeds"):
        rm.randmask(torch.tensor([5]), params, data)
