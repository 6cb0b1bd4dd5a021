"""Round apply: one scheduler round's data movement for a batch of rows.

The port's counterpart of the JAX package's Pallas whole-round kernel
(erlamsa_tpu/ops/pallas_kernels.py::fused_round_single, portable build).
Per row, ``params[b]`` (see PARAM_FIELDS) selects one application:

  SPLICE      out = d[:pos] ++ R ++ d[pos+drop:], R a span repeated
              ``reps`` times or a literal repeated that many times
  SWAP        exchange adjacent spans [a1, a1+l1) and [a1+l1, a1+l1+l2)
  MASK        per-byte NAND/OR/XOR/replace with probability (bit rows 0-2)
  PERM_BYTES  Fisher-Yates over at most 256 bytes (bit row 3)

and every other kind copies the row. The random bits are
``jax.random.bits(key, (4, L), uint32)`` of the row's key, reproduced
word for word.

Two versions compute the same function: the CUDA kernel
(csrc/round_apply.cu) for tensors on a GPU, and ``round_apply_plain``,
plain PyTorch, for tensors on the CPU (and as the kernel's yardstick).
``round_apply`` takes the plain version only because its tensors lie on
the CPU; on a CUDA tensor it launches the kernel or raises. The kernel
stages a row in shared memory when L <= SMEM_MAX_L and reads it from
device memory otherwise (``path``); it takes rows whose width is a
multiple of 16, as every capacity class is.

Edge cases follow the TPU kernel, not the JAX engine's composite gather:
its rolls index modulo L, so a repeated span reads
``d[(src_start + (i-pos) mod src_len) mod L]`` and the tail
``d[(i - rlen + drop) mod L]``, and a literal byte whose offset
``(i-pos) mod lit_len`` is 48 or more reads 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, prng
from .rows import positions

K_NONE, K_SPLICE, K_SWAP, K_PERM_BYTES, K_PERM_LINES, K_MASK = range(6)
SRC_NONE, SRC_SPAN, SRC_LIT = range(3)
SCRATCH = 48
FY_CAP = 256  # Fisher-Yates window cap (fused.PERM_WINDOW)
SMEM_MAX_L = 65536  # widest row the kernels hold in shared memory

PARAM_FIELDS = (
    "kind", "pos", "drop", "src", "src_start", "src_len", "reps", "lit_len",
    "a1", "l1", "l2", "ps", "pl", "mask_op", "mask_prob", "n",
)

# kernel launches since the last reset (plain-version calls do not count)
launches = 0
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def path(L: int) -> str:
    """Where the CUDA kernels keep a row of L bytes: "shared" memory for
    the 65536 class and below, "device" memory above."""
    return "shared" if L <= SMEM_MAX_L else "device"


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("round_apply"))
        fn = lib.round_apply_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if lib.round_apply_smem_max_l() != SMEM_MAX_L:
            raise RuntimeError("round_apply: the kernel's shared-memory cap "
                               "differs from SMEM_MAX_L")
        _lib = lib
    return _lib


def ctas_per_sm(L: int) -> int:
    """Resident CTAs per SM of the kernel for rows of L bytes (the CUDA
    occupancy calculator, on the current card)."""
    n = _load().round_apply_ctas_per_sm(L)
    if n < 0:
        raise RuntimeError(
            f"round_apply: occupancy query failed (cuda error {-n})")
    return n


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself if its data starts on a 16-byte boundary (the kernels'
    16-byte loads need it), else an aligned copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(keys, params, lit, data):
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError("round_apply: data must be uint8[B, L]")
    B = data.shape[0]
    want = ((keys, torch.int64, (B, 2), "keys"),
            (params, torch.int32, (B, 16), "params"),
            (lit, torch.uint8, (B, SCRATCH), "lit"))
    for t, dt, shape, name in want:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"round_apply: {name} must be {dt}{list(shape)}, "
                             f"got {t.dtype}{list(t.shape)}")
    for t in (keys, params, lit, data):
        if t.device != data.device:
            raise ValueError("round_apply: all operands on one device")
        if not t.is_contiguous():
            raise ValueError("round_apply: operands must be contiguous")


def round_apply(keys, params, lit, data):
    """uint8[B, L] result of each row's round program.

    keys int64[B, 2]: fold_in(site_key, TAG_VAL) per row; params
    int32[B, 16] (PARAM_FIELDS); lit uint8[B, 48]; data uint8[B, L]."""
    global launches
    _check(keys, params, lit, data)
    if data.device.type == "cpu":
        return round_apply_plain(keys, params, lit, data)
    if data.device.type != "cuda":
        raise RuntimeError(f"round_apply: unsupported device {data.device}")
    B, L = data.shape
    if L % 16:
        raise ValueError("round_apply: the kernel takes rows whose width is a "
                         f"multiple of 16, got {L}")
    out = torch.empty_like(data)
    if B == 0:
        return out
    data = aligned(data)
    lib = _load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.round_apply_launch(
            data.data_ptr(), params.data_ptr(), lit.data_ptr(),
            keys.data_ptr(), out.data_ptr(), B, L, stream)
    if rc != 0:
        raise RuntimeError(f"round_apply: kernel launch failed (cuda error {rc})")
    launches += 1
    return out


def round_apply_plain(keys, params, lit, data):
    """The same function in plain PyTorch, on any device."""
    B, L = data.shape
    dev = data.device
    P = params.to(torch.int64)
    (kind, pos, drop, src, src_start, src_len, reps, lit_len, a1, l1, l2,
     ps, plen, mask_op, mask_prob, n) = (P[:, j] for j in range(16))
    i = positions(L, dev)[None, :]
    d = data
    col = lambda x: x[:, None]  # noqa: E731

    def at(idx):
        return _gather_mod(d, idx)

    # SPLICE
    pos_c = torch.minimum(pos.clamp(min=0), n)
    drop_c = torch.minimum(drop.clamp(min=0), n - pos_c)
    rlen = torch.where(src == SRC_SPAN, src_len * reps,
                       torch.where(src == SRC_LIT,
                                   lit_len * reps.clamp(min=1), 0))
    rlen = rlen.clamp(0, L)
    off = (i - col(pos_c)).clamp(min=0)
    span_b = at(col(src_start) + torch.remainder(off, col(src_len.clamp(min=1))))
    m = torch.remainder(off, col(lit_len.clamp(min=1)))
    lit_b = torch.gather(lit, 1, m.clamp(max=SCRATCH - 1))
    lit_b = torch.where(m < min(SCRATCH, L), lit_b, 0)
    repl = torch.where(col(src == SRC_LIT), lit_b, span_b)
    tail = at(i - col(rlen) + col(drop_c))
    n_sp = (n - drop_c + rlen).clamp(0, L)
    sp = torch.where(i < col(pos_c), d,
                     torch.where(i < col(pos_c + rlen), repl, tail))
    sp = torch.where(i < col(n_sp), sp, 0)

    # SWAP
    in1 = (i >= col(a1)) & (i < col(a1 + l2))
    in2 = (i >= col(a1 + l2)) & (i < col(a1 + l2 + l1))
    sw = torch.where(in1, at(i + col(l1)), torch.where(in2, at(i - col(l2)), d))

    out = torch.where(col(kind == K_SPLICE), sp,
                      torch.where(col(kind == K_SWAP), sw, d))

    # MASK: random words only for the rows that mask
    rows = torch.nonzero(kind == K_MASK).flatten()
    if rows.numel():
        bits = prng.bits(keys[rows], (3, L))
        dm = d[rows]
        occ_n = torch.remainder(bits[:, 0], 100)
        mp = col(mask_prob[rows])
        occurs = torch.where(mp == 1, occ_n != 0, occ_n < mp)
        one = (1 << torch.remainder(bits[:, 1], 8)).to(torch.uint8)
        rnd = (bits[:, 2] & 0xFF).to(torch.uint8)
        op = col(mask_op[rows])
        masked = torch.where(op == 0, dm & ~one, torch.where(
            op == 1, dm | one, torch.where(op == 2, dm ^ one, rnd)))
        hit = (i >= col(ps[rows])) & (i < col(ps[rows] + plen[rows])) & occurs
        out[rows] = torch.where(hit, masked, dm)

    # PERM_BYTES: the serial Fisher-Yates, batched over the rows that permute
    rows = torch.nonzero(kind == K_PERM_BYTES).flatten()
    if rows.numel():
        wf = min(FY_CAP, L)
        w = positions(wf, dev)[None, :]
        psr = col(ps[rows])
        span = plen[rows].clamp(0, wf)
        win = _gather_mod(d[rows], psr + w)
        vrow = prng.bits_at(keys[rows], 3 * L + w)
        ar = torch.arange(rows.numel(), device=dev)
        for t in range(int(span.max()) - 1):
            j = span - 1 - t
            live = j >= 1
            jc = j.clamp(min=0)
            r = torch.remainder(vrow[ar, jc], jc + 1)
            vj = win[ar, jc]
            vr = win[ar, r]
            win[ar, jc] = torch.where(live, vr, vj)
            win[ar, r] = torch.where(live, vj, vr)
        src_w = (i - psr).clamp(0, wf - 1)
        inwin = (i >= psr) & (i < psr + col(span))
        out[rows] = torch.where(inwin, torch.gather(win, 1, src_w), d[rows])
    return out


def _gather_mod(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx mod L]: the TPU kernel's rolls index modulo the row."""
    return torch.gather(x, 1, torch.remainder(idx, x.shape[1]))
