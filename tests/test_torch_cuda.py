"""erlamsa_tpu_torch on the card: the CUDA kernels (round apply, case
rounds, random mask) against their plain PyTorch versions, and the GPU
main path against the CPU one in each stream. The round and case kernels
are held at L = 256, 8192 and 65536 (their shared-memory path) and at
L = 1,000,000 (their device-memory path).

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor the JAX package, so on a machine with a card and
no jax it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from erlamsa_tpu_torch.ops import case_rounds as cr
from erlamsa_tpu_torch.ops import prng
from erlamsa_tpu_torch.ops import randmask as rm
from erlamsa_tpu_torch.ops import round_apply as ra
from erlamsa_tpu_torch.ops.buffers import pack
from erlamsa_tpu_torch.ops.pipeline import make_class_fuzzer
from erlamsa_tpu_torch.ops.registry import DEFAULT_DEVICE_PRI
from erlamsa_tpu_torch.ops.scheduler import init_scores


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _programs(rng, B, L):
    P = np.zeros((B, 16), np.int32)
    P[:, 0] = rng.integers(0, 6, B)
    n = rng.integers(0, L + 1, B)
    P[:, 15] = n
    P[:, 1] = rng.integers(0, L + 1, B)
    P[:, 2] = rng.integers(0, L + 1, B)
    P[:, 3] = rng.integers(0, 3, B)
    P[:, 4] = rng.integers(-L, 2 * L, B)
    P[:, 5] = rng.integers(0, 2 * L, B)
    P[:, 6] = rng.integers(0, 600, B)
    P[:, 7] = rng.integers(0, 80, B)
    P[:, 8] = rng.integers(0, L, B)
    P[:, 9] = rng.integers(0, L // 2, B)
    P[:, 10] = rng.integers(0, L // 2, B)
    P[:, 11] = rng.integers(-300, L + 5, B)
    P[:, 12] = rng.integers(0, 300, B)
    P[:, 13] = rng.integers(0, 4, B)
    P[:, 14] = rng.integers(1, 101, B)
    return P


@pytest.mark.cuda
@pytest.mark.parametrize("L", [256, 8192, 65536, 1000000])
def test_kernel_equals_plain(cuda_device, L):
    rng = np.random.default_rng(L)
    B = 256 if ra.path(L) == "shared" else 8
    args = [
        torch.from_numpy(rng.integers(0, 2**32, (B, 2), dtype=np.int64)),
        torch.from_numpy(_programs(rng, B, L)),
        torch.from_numpy(rng.integers(0, 256, (B, ra.SCRATCH), dtype=np.uint8)),
        torch.from_numpy(rng.integers(0, 256, (B, L), dtype=np.uint8)),
    ]
    dev = [a.to(cuda_device) for a in args]
    before = ra.launches
    out = ra.round_apply(*dev)
    torch.cuda.synchronize()
    assert ra.launches == before + 1
    want = ra.round_apply_plain(*dev)
    assert torch.equal(out, want)


def _case_operands(rng, B, L, dev):
    """Rows of text lines, length-prefixed blobs and binary, a quarter
    filled to the row end; random keys and scores; every round count
    0-16 when B >= 17."""
    data = np.zeros((B, L), np.uint8)
    n = np.empty(B, np.int32)
    for b in range(B):
        ln = L if b % 4 == 0 else int(rng.integers(0, L + 1))
        if b % 3 == 0:
            row = (b"line %d value=-%d\n" % (b, rng.integers(1 << 30))) * L
        elif b % 3 == 1:
            row = b"HD" + min(max(ln - 4, 0), 0xFFFF).to_bytes(2, "big") + bytes(
                rng.integers(33, 127, L, dtype=np.uint8))
        else:
            row = bytes(rng.integers(0, 256, L, dtype=np.uint8))
        data[b, :ln] = np.frombuffer(row[:ln], np.uint8)
        n[b] = ln
    rounds = rng.permutation(np.arange(B) % 17).astype(np.int32)
    host = (rng.integers(0, 2**32, (B, 2), dtype=np.int64), data, n,
            rng.integers(2, 11, (B, cr.M)).astype(np.int32), rounds)
    return [torch.from_numpy(x).to(dev) for x in host]


@pytest.mark.cuda
@pytest.mark.parametrize("L", [256, 8192, 65536, 1000000])
def test_case_rounds_kernel_equals_plain(cuda_device, L):
    rng = np.random.default_rng(L + 1)
    B = {256: 128, 8192: 128, 65536: 34}.get(L, 17)
    keys, data, n, scores, rounds = _case_operands(rng, B, L, cuda_device)
    pris = [torch.tensor(DEFAULT_DEVICE_PRI, dtype=torch.int32)]
    if L == 256:
        pris += [torch.eye(cr.M, dtype=torch.int32)[m] for m in range(cr.M)]
        # one priority at 3e8: score x priority wraps in int32
        big = pris[0].clone()
        big[5] = 300_000_000
        pris.append(big)
    for pri in pris:
        args = (keys, data, n, scores, pri.to(cuda_device), rounds)
        before = cr.launches
        got = cr.case_rounds(*args)
        torch.cuda.synchronize()
        assert cr.launches == before + 1
        for a, b in zip(got, cr.case_rounds_plain(*args)):
            assert torch.equal(a, b)


def _mask_edges(L):
    """(s, l, op, prob, active) rows at the mask's edges: span ends that
    wrap in int32 (negative, to a large positive) or sit at 2^31 - 1, an
    inactive row, empty spans (l = 0, l < 0), prob 0, 1, 100 and 101, ops
    3, 4 and -1 (replace)."""
    return [(5, 2**31 - 2, 2, 100, 1), (-2**31 + 5, -10, 2, 100, 1),
            (3, 2**31 - 4, 3, 100, 1), (4, 2**31 - 4, 3, 100, 1),
            (0, L, 2, 100, 0), (L // 3, 0, 2, 100, 1), (L // 2, -5, 4, 100, 1),
            (0, L, 0, 0, 1), (0, L, 1, 1, 1), (0, L, 2, 100, 1),
            (0, L, 3, 101, 1), (1, L, 4, 50, 1), (1, L - 2, -1, 50, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("L", [17, 256, 4099, 8192])
def test_randmask_kernel_equals_plain(cuda_device, L):
    """Random rows and the edge rows, at widths that are and are not a
    multiple of 16, with the rows aligned and starting one byte past a
    16-byte boundary."""
    rng = np.random.default_rng(L + 2)
    B = 64
    seeds = torch.from_numpy(rng.integers(-2**31, 2**31, B).astype(np.int32))
    params = np.stack([
        rng.integers(-8, L, B), rng.integers(0, L + 8, B),
        rng.integers(0, 5, B), rng.integers(0, 102, B),
        rng.integers(0, 3, B)], 1)
    edges = _mask_edges(L)
    params[:len(edges)] = edges
    params = torch.from_numpy(params.astype(np.int32))
    buf = torch.from_numpy(rng.integers(0, 256, B * L + 1, dtype=np.uint8))
    seeds, params, buf = (x.to(cuda_device) for x in (seeds, params, buf))
    data, unaligned = buf[:-1].view(B, L), buf[1:].view(B, L)
    assert unaligned.data_ptr() % 16 != 0
    keys = rm.seed_keys(seeds)
    before = rm.launches
    got = rm.randmask(seeds, params, data)
    got_u = rm.randmask_keys(keys, params, unaligned)
    one = rm.randmask_single(keys[2], params[2], data[2])
    torch.cuda.synchronize()
    assert rm.launches == before + 3
    want = rm.randmask_plain(keys, params, data)
    assert torch.equal(got, want)
    assert torch.equal(got_u, rm.randmask_plain(keys, params, unaligned))
    assert torch.equal(one, want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_main_path_gpu_equals_cpu(cuda_device, level):
    rng = np.random.default_rng(3)
    seeds = [b"line %d value=%d\n" % (i, rng.integers(1 << 30)) * 3
             for i in range(24)]
    seeds += [bytes(rng.integers(0, 256, 200, dtype=np.uint8)) for _ in range(8)]
    idx = np.arange(len(seeds), dtype=np.int64)
    base = prng.base_key((5, 6, 7))
    res = {}
    for dev in ("cpu", cuda_device):
        step = make_class_fuzzer(device=dev, level=level)
        b = pack(seeds, capacity=1024, device=dev)
        scores = init_scores(prng.fold_in(base.to(dev), 999), len(seeds))
        data, lens = b.data, b.lens
        before = cr.launches
        for case in range(3):
            data, lens, scores, meta = step(base.to(dev), case, idx, data,
                                            lens, scores)
        if dev == cuda_device:
            assert cr.launches - before == (3 if level == 2 else 0)
        res[str(dev)] = [x.cpu() for x in (data, lens, scores, meta.applied)]
    for a, b in zip(res["cpu"], res[str(cuda_device)]):
        assert torch.equal(a, b)
