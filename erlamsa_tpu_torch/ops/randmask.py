"""Random mask: per row, a per-byte NAND / OR / XOR / replace over a span
with a probability (the snand / srnd byte transform).

The port's counterpart of the JAX package's Pallas mask kernels
(erlamsa_tpu/ops/pallas_kernels.py::pallas_randmask and
randmask_single, portable build; both run _mask_logic). A row's
``params`` are (s, l, op, prob, active): bytes i in [s, s+l) take op
(0 NAND, 1 OR, 2 XOR of one bit, anything else a random byte) where the
occurrence draw fires, when ``active`` is nonzero. The random bits are
``jax.random.bits(key, (3, L), uint32)`` of the row's key, reproduced
word for word.

Two versions compute the same function: the CUDA kernel
(csrc/randmask.cu) for tensors on a GPU, and ``randmask_plain``, plain
PyTorch, for tensors on the CPU (and as the kernel's yardstick). The
wrappers take the plain version only because their tensors lie on the
CPU; on a CUDA tensor they launch the kernel or raise. The kernel takes
any L and any alignment of the rows. The span end ``s + l`` wraps in
int32 in both, as in the reference. No engine path calls them, as in the
JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, prng
from .rows import positions, select

_lib = None
# kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def seed_keys(seeds: torch.Tensor) -> torch.Tensor:
    """jax.random.key(seed) of int32 seeds: the words (0, seed mod 2^32)."""
    s = seeds.to(torch.int64) & prng.M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def randmask(seeds, params, data):
    """uint8[B, L]: each row masked under key(seeds[b]) (pallas_randmask).
    seeds int32[B], params int32[B, 5], data uint8[B, L]."""
    if seeds.dim() != 1 or seeds.shape[0] != data.shape[0]:
        raise ValueError("randmask: seeds must be int[B]")
    return randmask_keys(seed_keys(seeds), params, data)


def randmask_single(key, params_row, data_row):
    """uint8[L]: one row masked under ``key`` int64[2] (randmask_single)."""
    return randmask_keys(key.reshape(1, 2), params_row.reshape(1, 5),
                         data_row.reshape(1, -1))[0]


def _check(keys, params, data):
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError("randmask: data must be uint8[B, L]")
    B = data.shape[0]
    for x, dt, shape, name in ((keys, torch.int64, (B, 2), "keys"),
                               (params, torch.int32, (B, 5), "params")):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"randmask: {name} must be {dt}{list(shape)}, "
                             f"got {x.dtype}{list(x.shape)}")
        if x.device != data.device:
            raise ValueError("randmask: all operands on one device")


def randmask_keys(keys, params, data):
    """The mask of every row under its own key int64[B, 2]."""
    global launches
    _check(keys, params, data)
    if data.device.type == "cpu":
        return randmask_plain(keys, params, data)
    if data.device.type != "cuda":
        raise RuntimeError(f"randmask: unsupported device {data.device}")
    B, L = data.shape
    keys, params, data = (x.contiguous() for x in (keys, params, data))
    out = torch.empty_like(data)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.randmask_launch(keys.data_ptr(), params.data_ptr(),
                                 data.data_ptr(), out.data_ptr(), B, L,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"randmask: kernel launch failed (cuda error {rc})")
    launches += 1
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("randmask"))
        fn = lib.randmask_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ctas_per_sm() -> int:
    """Resident CTAs per SM of the kernel (the CUDA occupancy calculator,
    on the current card); it takes no dynamic shared memory, so any L."""
    n = _load().randmask_ctas_per_sm()
    if n < 0:
        raise RuntimeError(
            f"randmask: occupancy query failed (cuda error {-n})")
    return n


def randmask_plain(keys, params, data):
    """The same function in plain PyTorch, on any device."""
    B, L = data.shape
    i = positions(L, data.device)[None, :]
    s, l, op, prob, active = (params[:, j].to(torch.int64)[:, None]
                              for j in range(5))
    bits = prng.bits(keys, (3, L))
    occ = torch.remainder(bits[:, 0], 100)
    occurs = torch.where(prob == 1, occ != 0, occ < prob)
    one = (1 << torch.remainder(bits[:, 1], 8)).to(torch.uint8)
    rnd = (bits[:, 2] & 0xFF).to(torch.uint8)
    masked = select([op == 0, op == 1, op == 2],
                    [data & ~one, data | one, data ^ one], rnd)
    # the span end wraps in int32 as the reference's `s + l` does
    hit = (i >= s) & (i < prng.wrap32(s + l)) & occurs & (active != 0)
    return torch.where(hit, masked, data)
