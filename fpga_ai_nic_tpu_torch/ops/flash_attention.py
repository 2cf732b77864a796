"""Flash attention, forward and backward — the port of the JAX package's
``ops/flash_pallas.py``.

``flash_attention`` is differentiable through ``_FlashFunction``, whose
forward keeps ``lse`` and whose backward recomputes ``p`` from it, as the
JAX ``custom_vjp`` does.  Each of its three steps
has a plain version here that repeats the kernels' arithmetic in torch
(``flash_fwd_plain``, ``flash_dq_plain``, ``flash_dkv_plain``) and a CUDA
kernel on the tensor cores: the forward in ``csrc/flash_attn.cu``, dq and
dk/dv in ``csrc/flash_bwd.cu``.  A tensor on the CPU takes the plain
version; a tensor on CUDA launches a kernel or raises.  There is no
fallback between the two.  ``FLASH_FWD``, ``FLASH_DQ`` and ``FLASH_DKV``
count kernel launches; ``FLASH_*_OFFSETS`` count the launches whose q/k
offsets move the causal mask (the same entries, the kernels' offset
instantiations).

The tensor-core kernels take bf16 q, k and v with Sq and Sk multiples of
``TILE``, each at the head dims it is built for (``TENSOR_CORE_HEAD_DIMS``,
``tensor_cores_take``, decided per kernel): all three at 128 (Llama-3's)
and 64 (BERT-base's).  Every other CUDA call that ``supported()`` takes,
in float32, bfloat16 or float16 (``GENERIC_DTYPES``), launches the
second family,
``csrc/flash_generic.cu``: f32 on the CUDA cores, for any head_dim the
JAX package's predicate allows, as the Pallas kernels run every dtype and
head_dim.  ``FLASH_FWD_GENERIC``, ``FLASH_DQ_GENERIC`` and
``FLASH_DKV_GENERIC`` count its launches.  Other dtypes raise.  Both
families write the natural-log lse, f32 [B, H, Sq].

Layouts: q is ``[B, H, Sq, hd]``, k and v are ``[B, Hkv, Sk, hd]`` with
Hkv dividing H (GQA: query head h reads KV head ``h // (H // Hkv)``; K/V
are never repeated, and dk/dv sum each group's query heads).
``block_q``/``block_k`` are the TPU kernels' VMEM tiling and only set the
plain versions' key blocking here.

``q_offset``/``k_offset`` (the Pallas kernels' ``off_ref`` pair) are the
global positions of q's and k's first rows: under ``causal`` key j is
seen by row i iff ``k_offset + j <= q_offset + i``, so a sequence shard
attending a visiting K/V chunk (``ops.ring_attention``'s sequence
parallelism) keeps causality over global positions.  Only the difference
``q_offset - k_offset`` enters the mask, and without ``causal`` the pair
changes nothing.  A row that sees no key (a chunk wholly in its future)
gets ``out = 0`` and ``lse = -1e30`` in every version, and zero gradients:
a logsumexp merge of such a hop is a no-op (JAX's kernels give that where
their whole block is skipped).  ``flash_attention(..., with_lse=True)``
returns ``(out, lse)``, both differentiable: the lse cotangent folds into
the backward's ``delta`` operand, ``delta = rowsum(dO * O) - d_lse``
(``flash_pallas._bwd``), so the kernels need no other input.  The CUDA
kernels take the offsets as their last scalar arguments; the tensor-core
ones build an instantiation for a non-zero difference beside the one
without (a template flag, as the key bias), so a launch with zero offsets
is the kernel it was before the channel existed.

``key_bias`` ([B, Sk] f32, the Pallas kernels' ``has_bias`` channel) is
added to every query row's scores after ``sm_scale``, before the online
softmax and before the backward's recompute of p; ``-1e30`` masks a key
(BERT's padding mask).  It is not differentiable (the JAX wrapper's
``stop_gradient``).  Both kernel families take it: the second family as
a null-or-not pointer, the tensor-core kernels as a template flag, so
their launches without it are the kernels they were before.

Numerics (``flash_pallas.py``'s contract): bf16 products summed in f32,
``p`` and ``ds`` kept in f32 through every product, one rounding to the
output dtype at the end.  The plain versions keep it exactly.  The
kernels run their products on the tensor cores, which take bf16
operands: ``s = q.k^T`` and ``dp = dO.v^T`` are exact there (bf16 inputs),
while ``p`` (into out and dv) and ``ds`` (into dq and dk) each enter as
two bf16 terms, ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, both products
summed in f32, which carries x to about 16 bits.  One bf16 rounding of p
and ds, as the library's bf16 backward does, was refused: emulated on the
CPU (``tests/test_torch_flash.py``, H=8, Hkv=2, S=1024, hd=128, causal,
bf16 inputs from seed 0) it gives ``tol_ratio`` 1.73 / 3.98 / 3.23 (dq / dk /
dv) against the limit of 1, near the card check's fault control (the
plain backward at lse + 0.05, about 3.6), so no looser limit could still
tell a fault apart; the hi + lo split gives 0.39 / 0.41 / 0.34 there and
at most 0.48 over GQA and MHA, causal or not, S of 256 and 1024.  The
forward's p is split the same way: emulated at the same sizes it gives
``tol_ratio`` 0.36-0.45 on the output, where one rounding gives 1.74-3.64.
At head_dim 64 with a padding mask (B=2, H=4, S of 256 and 512, causal
or not) the split gives 0.36-0.45 on the forward's output, 0.35-0.45
on dq and 0.36-0.46 on dk and dv, one rounding 1.50-2.79, 2.22-2.95 and
2.43-4.73.
Kernel and plain version sum in different orders, so they agree to that
limit, not bit for bit.  The second family keeps p and ds in f32 (no
split) and differs from the plain versions by the f32 sums' order only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import Kernel, ptr
from .bfp_cuda import check_cuda

LANES = 128
TILE = 64                   # rows of a q or k tile in the CUDA kernels
# the head dims each tensor-core kernel is built for: Llama-3's 128 and
# BERT-base's 64
TENSOR_CORE_HEAD_DIMS = {"fwd": (64, 128), "dq": (64, 128), "dkv": (64, 128)}
_NEG = -1e30
_DEF_BLOCK = 512

_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
FLASH_FWD = Kernel("flash_fwd", "flash_attn.cu", "flash_fwd_launch",
                   [ctypes.c_void_p] * 6 + _TAIL)
FLASH_DQ = Kernel("flash_dq", "flash_bwd.cu", "flash_dq_launch",
                  [ctypes.c_void_p] * 8 + _TAIL)
FLASH_DKV = Kernel("flash_dkv", "flash_bwd.cu", "flash_dkv_launch",
                   [ctypes.c_void_p] * 9 + _TAIL)
# the same C entries called with a causal shift (q_offset - k_offset) that
# is not zero, which run the kernels' OFF instantiations: counted apart
FLASH_FWD_OFFSETS = Kernel("flash_fwd_offsets", "flash_attn.cu",
                           "flash_fwd_launch", [ctypes.c_void_p] * 6 + _TAIL)
FLASH_DQ_OFFSETS = Kernel("flash_dq_offsets", "flash_bwd.cu",
                          "flash_dq_launch", [ctypes.c_void_p] * 8 + _TAIL)
FLASH_DKV_OFFSETS = Kernel("flash_dkv_offsets", "flash_bwd.cu",
                           "flash_dkv_launch", [ctypes.c_void_p] * 9 + _TAIL)

GENERIC_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
GENERIC_ROWS = 32           # rows a block of the second family owns
_GENERIC_TAIL = [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 2
FLASH_FWD_GENERIC = Kernel(
    "flash_fwd_generic", "flash_generic.cu", "flash_fwd_generic_launch",
    [ctypes.c_void_p] * 6 + _GENERIC_TAIL)
FLASH_DQ_GENERIC = Kernel(
    "flash_dq_generic", "flash_generic.cu", "flash_dq_generic_launch",
    [ctypes.c_void_p] * 8 + _GENERIC_TAIL)
FLASH_DKV_GENERIC = Kernel(
    "flash_dkv_generic", "flash_generic.cu", "flash_dkv_generic_launch",
    [ctypes.c_void_p] * 9 + _GENERIC_TAIL)


REL_TOL = 2.0 ** -6          # two to four bf16 ulps of each element
FLOOR_TOL = 2.0 ** -12       # of the tensor's largest magnitude
LSE_TOL = 1e-4


def tol_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / (REL_TOL * |want| + FLOOR_TOL * max|want|):
    at most 1 where kernel and plain version agree.  Both sum in f32 in
    other orders (relative differences near 1e-6) and round once to
    bf16, which moves an element by at most one ulp; the floor covers
    elements that cancel to near zero.  (``lse`` is f32 and held to
    ``LSE_TOL`` absolute instead.)"""
    g, w = got.double(), want.double()
    limit = REL_TOL * w.abs() + FLOOR_TOL * float(w.abs().max())
    return float(((g - w).abs() / limit).max())


def supported(q_shape, dtype=None, kv_seq_len=None) -> bool:
    """Can the fused kernels take this attention?  [B,H,S,dh] with S a
    lane multiple (blocks divide S exactly) and a lane-friendly head dim.
    ``kv_seq_len`` (Sk, when it differs from Sq) must be a lane multiple
    too.  The JAX package's predicate, unchanged.  The CUDA kernels take
    all of it in float32, bfloat16 and float16."""
    if len(q_shape) != 4:
        return False
    S, dh = q_shape[2], q_shape[3]
    if kv_seq_len is not None and kv_seq_len % LANES != 0:
        return False
    return S % LANES == 0 and dh % 8 == 0 and dh <= 256


def kernels_take(q_shape, device_type: str,
                 kv_seq_len: Optional[int] = None) -> bool:
    """Does "auto" take the flash kernels?  On a CUDA device wherever
    ``supported()`` holds: the JAX package's rule (a TPU with tiling
    shapes) with the card in the TPU's place.  Pure (shape and device
    type), so a CPU test can hold it against JAX's decision; the dtype
    and head dim pick each kernel's family (``tensor_cores_take``), not
    the route."""
    return device_type == "cuda" and supported(q_shape,
                                               kv_seq_len=kv_seq_len)


def tensor_cores_take(kernel: str, q_shape, dtypes,
                      kv_seq_len: Optional[int] = None) -> bool:
    """Is the tensor-core ``kernel`` ("fwd", "dq" or "dkv") built for
    these operands?  q, k and v all bf16, a head_dim of
    ``TENSOR_CORE_HEAD_DIMS[kernel]``, Sq and Sk multiples of ``TILE``.
    Elsewhere a CUDA call takes that kernel of the second family."""
    Sk = q_shape[2] if kv_seq_len is None else kv_seq_len
    return (all(d == torch.bfloat16 for d in dtypes)
            and q_shape[3] in TENSOR_CORE_HEAD_DIMS[kernel]
            and q_shape[2] % TILE == 0 and Sk % TILE == 0)


def _grouped(t: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, H, S, d] -> f32 [B, Hkv, G, S, d] (a view where possible)."""
    B, H = t.shape[:2]
    return t.to(torch.float32).reshape(B, Hkv, H // Hkv, *t.shape[2:])


def _causal_mask(Sq: int, k0: int, bk: int, q_offset: int,
                 device, k_offset: int = 0) -> torch.Tensor:
    """[Sq, bk] True where key k_offset + k0 + j lies after query row
    q_offset + i."""
    qpos = q_offset + torch.arange(Sq, device=device)
    kpos = k_offset + k0 + torch.arange(bk, device=device)
    return kpos[None, :] > qpos[:, None]


def _unseen(Sq: int, k0: int, causal: bool, q_offset: int,
            k_offset: int) -> bool:
    """Does no row of q see key k0 or any later one?  (The Pallas kernels'
    causal block skip, for a block that starts at key k0.)"""
    return causal and k_offset + k0 > q_offset + Sq - 1


def _dead_rows(Sq: int, causal: bool, q_offset: int, k_offset: int,
               device) -> Optional[torch.Tensor]:
    """[Sq] True for the rows that see no key at all, or None where every
    row sees one."""
    if not causal or q_offset >= k_offset:
        return None
    return q_offset + torch.arange(Sq, device=device) < k_offset


def _bias_block(key_bias: Optional[torch.Tensor], k0: int, bk: int):
    """Key block [k0, k0 + bk) of a [B, Sk] bias, shaped to add to grouped
    scores [B, Hkv, G, Sq, bk]; None without a bias."""
    if key_bias is None:
        return None
    return key_bias[:, None, None, None, k0:k0 + bk].to(torch.float32)


# -- plain versions -----------------------------------------------------------

def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: float,
                    block_k: int = _DEF_BLOCK, q_offset: int = 0,
                    key_bias: Optional[torch.Tensor] = None,
                    k_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, Sq, hd] in q's dtype, lse [B, H, Sq] f32)``: the
    forward kernel's online softmax over key blocks of ``block_k``, key
    blocks wholly after every row skipped.  ``q_offset``/``k_offset`` are
    the global positions of q's and k's first rows (they shift the causal
    mask); a row that sees no key gets out 0 and lse -1e30.  ``key_bias``
    [B, Sk] is added to the scaled scores before the causal mask."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qf = _grouped(q, Hkv)
    m = torch.full((*qf.shape[:-1], 1), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, Sk, block_k):
        if _unseen(Sq, k0, causal, q_offset, k_offset):
            break
        kb = k[:, :, k0:k0 + block_k].to(torch.float32)
        vb = v[:, :, k0:k0 + block_k].to(torch.float32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * sm_scale
        bias = _bias_block(key_bias, k0, kb.shape[2])
        if bias is not None:
            s = s + bias
        if causal:
            s = s.masked_fill(_causal_mask(Sq, k0, kb.shape[2], q_offset,
                                           q.device, k_offset), _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / safe).to(q.dtype).reshape(B, H, Sq, hd)
    lse = (m + torch.log(safe)).reshape(B, H, Sq)
    dead = _dead_rows(Sq, causal, q_offset, k_offset, q.device)
    if dead is not None:
        out = out.masked_fill(dead[:, None], 0)
        lse = lse.masked_fill(dead, _NEG)
    return out, lse


def _bwd_block(q, k, v, do, lse, delta, k0, block_k, causal, sm_scale,
               key_bias=None, q_offset=0, k_offset=0):
    """p and ds of one key block, both f32 [B, Hkv, G, Sq, bk]; p =
    exp(s * sm_scale + bias - lse) with the bias in every block."""
    Hkv, Sq = k.shape[1], q.shape[2]
    qf, dof = _grouped(q, Hkv), _grouped(do, Hkv)
    kb = k[:, :, k0:k0 + block_k].to(torch.float32)
    vb = v[:, :, k0:k0 + block_k].to(torch.float32)
    lse_g = _grouped(lse[..., None], Hkv)
    delta_g = _grouped(delta[..., None], Hkv)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * sm_scale
    bias = _bias_block(key_bias, k0, kb.shape[2])
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse_g)
    if causal:
        p = p.masked_fill(_causal_mask(Sq, k0, kb.shape[2], q_offset,
                                       q.device, k_offset), 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vb)
    ds = p * (dp - delta_g) * sm_scale
    return p, ds, qf, dof, kb


def flash_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   *, causal: bool, sm_scale: float,
                   block_k: int = _DEF_BLOCK,
                   key_bias: Optional[torch.Tensor] = None,
                   q_offset: int = 0, k_offset: int = 0) -> torch.Tensor:
    """dq [B, H, Sq, hd] in q's dtype: p = exp(s - lse) recomputed per key
    block, ds = p * (dp - delta) * sm_scale, dq = sum of ds . k in f32.
    ``delta = rowsum(dO * O) - d_lse`` (f32 [B, H, Sq])."""
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    dq = torch.zeros((B, Hkv, H // Hkv, Sq, hd), dtype=torch.float32,
                     device=q.device)
    for k0 in range(0, k.shape[2], block_k):
        if _unseen(Sq, k0, causal, q_offset, k_offset):
            break
        _, ds, _, _, kb = _bwd_block(q, k, v, do, lse, delta, k0, block_k,
                                     causal, sm_scale, key_bias, q_offset,
                                     k_offset)
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
    return dq.reshape(B, H, Sq, hd).to(q.dtype)


def flash_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    *, causal: bool, sm_scale: float,
                    block_k: int = _DEF_BLOCK,
                    key_bias: Optional[torch.Tensor] = None,
                    q_offset: int = 0, k_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Hkv, Sk, hd] in k's / v's dtype: per key block,
    dk = sum over the group's query heads and rows of ds^T . q and
    dv = sum of p^T . dO, in f32; zero for keys no row sees."""
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for k0 in range(0, k.shape[2], block_k):
        if _unseen(q.shape[2], k0, causal, q_offset, k_offset):
            break
        p, ds, qf, dof, _ = _bwd_block(q, k, v, do, lse, delta, k0, block_k,
                                       causal, sm_scale, key_bias, q_offset,
                                       k_offset)
        dk[:, :, k0:k0 + block_k] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
        dv[:, :, k0:k0 + block_k] = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    return dk, dv


# -- kernel launches ----------------------------------------------------------

def _check_kernel_operands(kernel: str, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> None:
    """What the tensor-core ``kernel`` takes: bf16, a head_dim it is built
    for (``TENSOR_CORE_HEAD_DIMS``), sequences in whole tiles, contiguous
    CUDA tensors."""
    hd, built = q.shape[-1], TENSOR_CORE_HEAD_DIMS[kernel]
    if hd not in built or k.shape[-1] != hd or v.shape[-1] != hd:
        raise ValueError(f"the tensor-core flash {kernel} kernel takes "
                         f"head_dim {' or '.join(map(str, built))}, got q "
                         f"{hd}, k {k.shape[-1]}, v {v.shape[-1]}")
    if q.shape[2] % TILE or k.shape[2] % TILE:
        raise ValueError(f"the tensor-core flash kernels need Sq and Sk multiples of "
                         f"{TILE}, got {q.shape[2]} and {k.shape[2]}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_cuda(t, torch.bfloat16, name)


def _shifted(causal: bool, q_offset: int, k_offset: int) -> bool:
    """Do the offsets move the causal mask (the kernels' OFF
    instantiations)?"""
    return bool(causal) and q_offset != k_offset


def _bias_ptr(key_bias: Optional[torch.Tensor], q: torch.Tensor,
              k: torch.Tensor):
    """The kernels' bias operand: null without a bias, else a contiguous
    f32 CUDA [B, Sk] tensor's address."""
    if key_bias is None:
        return None
    check_cuda(key_bias, torch.float32, "key_bias")
    if tuple(key_bias.shape) != (q.shape[0], k.shape[2]):
        raise ValueError(f"key_bias must be {(q.shape[0], k.shape[2])}, got "
                         f"{tuple(key_bias.shape)}")
    return ptr(key_bias)


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, sm_scale: float,
                   key_bias: Optional[torch.Tensor] = None,
                   q_offset: int = 0, k_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(out bf16, lse f32)``; with ``key_bias``
    its bias instantiation, with offsets whose difference is not zero
    (under ``causal``) its offset one."""
    _check_kernel_operands("fwd", q, k, v)
    bias = _bias_ptr(key_bias, q, k)
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    kern = FLASH_FWD_OFFSETS if _shifted(causal, q_offset, k_offset) \
        else FLASH_FWD
    kern(ptr(q), ptr(k), ptr(v), bias, ptr(out), ptr(lse), B * H, H // Hkv,
         H, Sq, Sk, int(causal), float(sm_scale), hd, int(q_offset),
         int(k_offset))
    return out, lse


def _check_bwd_operands(kernel, q, k, v, do, lse, delta) -> None:
    _check_kernel_operands(kernel, q, k, v)
    check_cuda(do, torch.bfloat16, "do")
    for t, name in ((lse, "lse"), (delta, "delta")):
        check_cuda(t, torch.float32, name)
        if t.shape != q.shape[:3]:
            raise ValueError(f"{name} must be {tuple(q.shape[:3])}, got "
                             f"{tuple(t.shape)}")
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}, got "
                         f"{tuple(do.shape)}")


def flash_dq_cuda(q, k, v, do, lse, delta, *, causal: bool,
                  sm_scale: float,
                  key_bias: Optional[torch.Tensor] = None,
                  q_offset: int = 0, k_offset: int = 0) -> torch.Tensor:
    """The dq kernel: dq bf16 [B, H, Sq, hd]."""
    _check_bwd_operands("dq", q, k, v, do, lse, delta)
    bias = _bias_ptr(key_bias, q, k)
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    kern = FLASH_DQ_OFFSETS if _shifted(causal, q_offset, k_offset) \
        else FLASH_DQ
    kern(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), bias,
         ptr(dq), B * H, H // Hkv, H, Sq, Sk, int(causal), float(sm_scale),
         hd, int(q_offset), int(k_offset))
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool,
                   sm_scale: float, key_bias: Optional[torch.Tensor] = None,
                   q_offset: int = 0, k_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel: (dk, dv) bf16 [B, Hkv, Sk, hd], each KV head's
    group of query heads summed in the kernel."""
    _check_bwd_operands("dkv", q, k, v, do, lse, delta)
    bias = _bias_ptr(key_bias, q, k)
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    kern = FLASH_DKV_OFFSETS if _shifted(causal, q_offset, k_offset) \
        else FLASH_DKV
    kern(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), bias,
         ptr(dk), ptr(dv), B * Hkv, H // Hkv, Hkv, Sq, Sk, int(causal),
         float(sm_scale), hd, int(q_offset), int(k_offset))
    return dk, dv


def _check_generic_operands(q, k, v, do=None, lse=None,
                            delta=None) -> int:
    """What ``csrc/flash_generic.cu`` takes: q, k, v (and do) in one of
    ``GENERIC_DTYPES``, head_dim a multiple of 8 up to 256, Sq and Sk
    multiples of ``GENERIC_ROWS``, H a multiple of Hkv, contiguous CUDA
    tensors; lse and delta f32 [B, H, Sq].  Returns the dtype code."""
    code = GENERIC_DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"the flash kernels take {list(GENERIC_DTYPES)}, "
                        f"got {q.dtype}")
    hd = q.shape[-1]
    if hd % 8 or hd > 256 or k.shape[-1] != hd or v.shape != k.shape:
        raise ValueError(f"the flash kernels take head_dim a multiple of 8 "
                         f"up to 256 in q, k and v, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] % GENERIC_ROWS or k.shape[2] % GENERIC_ROWS:
        raise ValueError(f"the flash kernels need Sq and Sk multiples of "
                         f"{GENERIC_ROWS}, got {q.shape[2]} and {k.shape[2]}")
    if q.shape[0] != k.shape[0] or q.shape[1] % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"share a batch and a head grouping")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do")):
        if t is not None:
            check_cuda(t, q.dtype, name)
    if do is not None and do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}, got "
                         f"{tuple(do.shape)}")
    for t, name in ((lse, "lse"), (delta, "delta")):
        if t is not None:
            check_cuda(t, torch.float32, name)
            if t.shape != q.shape[:3]:
                raise ValueError(f"{name} must be {tuple(q.shape[:3])}, "
                                 f"got {tuple(t.shape)}")
    return code


def flash_fwd_generic_cuda(q, k, v, *, causal: bool, sm_scale: float,
                           key_bias: Optional[torch.Tensor] = None,
                           q_offset: int = 0, k_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second family's forward: ``(out in q's dtype, lse f32)``."""
    code = _check_generic_operands(q, k, v)
    bias = _bias_ptr(key_bias, q, k)
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    FLASH_FWD_GENERIC(ptr(q), ptr(k), ptr(v), bias, ptr(out), ptr(lse), code,
                      B * H, H // Hkv, H, Sq, Sk, hd, int(causal),
                      float(sm_scale), int(q_offset), int(k_offset))
    return out, lse


def flash_dq_generic_cuda(q, k, v, do, lse, delta, *, causal: bool,
                          sm_scale: float,
                          key_bias: Optional[torch.Tensor] = None,
                          q_offset: int = 0, k_offset: int = 0
                          ) -> torch.Tensor:
    """The second family's dq, in q's dtype."""
    code = _check_generic_operands(q, k, v, do, lse, delta)
    bias = _bias_ptr(key_bias, q, k)
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    FLASH_DQ_GENERIC(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                     bias, ptr(dq), code, B * H, H // Hkv, H, Sq, Sk, hd,
                     int(causal), float(sm_scale), int(q_offset),
                     int(k_offset))
    return dq


def flash_dkv_generic_cuda(q, k, v, do, lse, delta, *, causal: bool,
                           sm_scale: float,
                           key_bias: Optional[torch.Tensor] = None,
                           q_offset: int = 0, k_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second family's (dk, dv), each KV head's group summed."""
    code = _check_generic_operands(q, k, v, do, lse, delta)
    bias = _bias_ptr(key_bias, q, k)
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_DKV_GENERIC(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                      bias, ptr(dk), ptr(dv), code, B * Hkv, H // Hkv, Hkv,
                      Sq, Sk, hd, int(causal), float(sm_scale),
                      int(q_offset), int(k_offset))
    return dk, dv


# -- dispatch: plain version on the CPU, a kernel on CUDA -----------------------

def _on_tensor_cores(kernel, q, k, v) -> bool:
    return tensor_cores_take(kernel, q.shape, (q.dtype, k.dtype, v.dtype),
                             kv_seq_len=k.shape[2])


def _fwd(q, k, v, key_bias, causal, sm_scale, block_k, offsets=(0, 0)):
    q_offset, k_offset = offsets
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               block_k=block_k, key_bias=key_bias,
                               q_offset=q_offset, k_offset=k_offset)
    fwd = flash_fwd_cuda if _on_tensor_cores("fwd", q, k, v) \
        else flash_fwd_generic_cuda
    return fwd(q, k, v, causal=causal, sm_scale=sm_scale, key_bias=key_bias,
               q_offset=q_offset, k_offset=k_offset)


def _bwd(q, k, v, do, lse, delta, key_bias, causal, sm_scale, block_k,
         offsets=(0, 0)):
    kw = dict(causal=causal, sm_scale=sm_scale, key_bias=key_bias,
              q_offset=offsets[0], k_offset=offsets[1])
    if q.device.type == "cpu":
        return (flash_dq_plain(q, k, v, do, lse, delta, block_k=block_k,
                               **kw),
                *flash_dkv_plain(q, k, v, do, lse, delta, block_k=block_k,
                                 **kw))
    dq = flash_dq_cuda if _on_tensor_cores("dq", q, k, v) \
        else flash_dq_generic_cuda
    dkv = flash_dkv_cuda if _on_tensor_cores("dkv", q, k, v) \
        else flash_dkv_generic_cuda
    return (dq(q, k, v, do, lse, delta, **kw),
            *dkv(q, k, v, do, lse, delta, **kw))


class _FlashFunction(torch.autograd.Function):
    """``(out, lse)`` of q, k, v (and an optional f32 key bias, saved
    beside them); the backward recomputes p from the saved lse with
    ``delta = rowsum(dO * O) - d_lse``, as ``flash_pallas._bwd`` does: the
    lse cotangent (absent when lse is unused) needs no other operand.  The
    bias and the offsets get no gradient (``stop_gradient`` and a float0
    cotangent in JAX)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, causal: bool, sm_scale: float,
                block_k: int, q_offset: int, k_offset: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if key_bias is not None:
            key_bias = key_bias.detach().to(torch.float32).contiguous()
        offsets = (q_offset, k_offset)
        out, lse = _fwd(q, k, v, key_bias, causal, sm_scale, block_k,
                        offsets)
        ctx.save_for_backward(q, k, v, out, lse, key_bias)
        ctx.args = (causal, sm_scale, block_k, offsets)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, d_lse):
        q, k, v, out, lse, key_bias = ctx.saved_tensors
        if d_out is None:
            d_out = torch.zeros_like(out)
        d_out = d_out.to(q.dtype).contiguous()
        delta = (d_out.to(torch.float32) * out.to(torch.float32)).sum(-1)
        if d_lse is not None:
            delta = delta - d_lse
        dq, dk, dv = _bwd(q, k, v, d_out, lse, delta, key_bias, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = _DEF_BLOCK, block_k: int = _DEF_BLOCK,
                    q_offset: int = 0, k_offset: int = 0,
                    key_bias: Optional[torch.Tensor] = None,
                    with_lse: bool = False):
    """Exact attention through the flash kernels, q: [B, H, Sq, hd], k/v:
    [B, Hkv, Sk, hd] -> [B, H, Sq, hd] in q's dtype (with ``with_lse``,
    ``(out, lse f32 [B, H, Sq])``, both differentiable: the entry
    ``flash_pallas._flash4(..., with_lse=True)`` gives the sequence-parallel
    ring).  Differentiable; the backward recomputes p from the saved lse,
    so residual memory is O(B*H*Sq*(hd+1)), never O(S^2).  ``block_q`` is
    accepted for the JAX signature and unused (the kernels tile by
    ``TILE``).

    ``q_offset``/``k_offset``: the global positions of q's and k's first
    rows, for causality over a sharded sequence (integers, as JAX's traced
    int32 pair); a row that sees no key gives out 0, lse -1e30 and no
    gradient.  ``key_bias`` ([B, Sk], cast to f32) is added to every query
    row's scores: the padding-mask channel (0 / -1e30), not
    differentiable.  JAX's precondition holds for the bias: every query
    row must see at least one unmasked key.  For a row whose keys are all
    masked by the bias the backward's recompute p = exp(s - lse) gives 1
    per key instead of 1/Sk (that row's gradients inflated about
    Sk-fold), and the forward degenerates: a uniform average of v in the
    plain version and the second family, zeros on the tensor-core
    kernels (their running max starts at -1e30 in log2 units, above a
    masked score)."""
    if key_bias is not None and tuple(key_bias.shape) != (q.shape[0],
                                                          k.shape[2]):
        raise ValueError(f"flash_attention: key_bias must be [B, Sk] = "
                         f"{[q.shape[0], k.shape[2]]}, got "
                         f"{list(key_bias.shape)}")
    if not supported(q.shape):
        raise ValueError(f"flash_attention: unsupported q shape "
                         f"{tuple(q.shape)}")
    H, hd = q.shape[1], q.shape[3]
    Hkv, Sk = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads={H} must be a multiple of kv heads={Hkv}")
    if Sk % LANES != 0:
        raise ValueError(
            f"flash kernels need the K/V sequence length to be a multiple "
            f"of {LANES} lanes, got Sk={Sk} (k/v shape {tuple(k.shape)}); "
            "pad the keys or use the plain attention path")
    if sm_scale is None:
        sm_scale = hd ** -0.5
    out, lse = _FlashFunction.apply(q, k, v, key_bias, bool(causal),
                                    float(sm_scale), int(block_k),
                                    int(q_offset), int(k_offset))
    return (out, lse) if with_lse else out


# -- sequence parallelism: the ring over the stacked sp ranks -------------------

def rotate(t: torch.Tensor) -> torch.Tensor:
    """One hop of the sp ring over the stacked ranks (leading dimension):
    rank i receives rank i - 1's chunk, as ``lax.ppermute`` with the pairs
    (i, i + 1) sends it; a copy into the neighbour's slot.  Its gradient
    is the reverse rotation, as the permute's transpose is."""
    return torch.roll(t, 1, dims=0)


def _lse_merge(out: torch.Tensor, lse: torch.Tensor, o_h: torch.Tensor,
               lse_h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logsumexp merge of two normalised partial attentions (f32 running
    output and lse; ``o_h`` in any dtype): a fully masked hop arrives as
    (0, -1e30) and merges as a no-op."""
    lse_n = torch.logaddexp(lse, lse_h)
    w, w_h = torch.exp(lse - lse_n), torch.exp(lse_h - lse_n)
    return (out * w[..., None]
            + o_h.to(torch.float32) * w_h[..., None]), lse_n


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis_name: str = "sp", *, causal: bool = True,
                         sm_scale: Optional[float] = None,
                         block_q: int = _DEF_BLOCK,
                         block_k: int = _DEF_BLOCK) -> torch.Tensor:
    """Sequence-parallel exact attention on the flash kernels
    (``flash_pallas.ring_flash_attention``), over n sp ranks stacked as
    the leading dimension (``axis_name`` names that axis): q [n, B, H,
    Sl, hd], k/v [n, B, Hkv, Sl, hd]; rank i holds global positions
    [i Sl, (i + 1) Sl).  Returns [n, B, H, Sl, hd] in q's dtype.

    Hop 0 attends each rank's own chunk; then K/V rotate one rank a hop
    (``rotate``, grouped: 1/G of the bytes of repeated K/V), and at hop s
    rank i holds chunk ``src = (i - s) % n``.  Each visible hop is one
    flash call with offsets ``(i Sl, src Sl)`` and ``with_lse=True``;
    under ``causal`` a chunk wholly in rank i's future (src > i) is
    skipped.  The partials merge by logsumexp in f32 (``_lse_merge``),
    cast once at the end.  Differentiable through every hop: each call's
    backward folds its lse cotangent into delta, and the rotations
    transpose to the reverse rotation."""
    n, _, _, Sl, hd = q.shape
    if not supported(q.shape[1:]):
        raise ValueError(f"ring_flash_attention: unsupported shard shape "
                         f"{tuple(q.shape[1:])}")
    if sm_scale is None:
        sm_scale = hd ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()

    def attend(i, kc, vc, src):
        return flash_attention(q[i], kc[i], vc[i], causal=causal,
                               sm_scale=sm_scale, block_q=block_q,
                               block_k=block_k, q_offset=i * Sl,
                               k_offset=src * Sl, with_lse=True)

    outs, lses = [], []
    for i in range(n):
        o, lse = attend(i, k, v, i)
        outs.append(o.to(torch.float32))
        lses.append(lse)
    kc, vc = k, v
    for s in range(1, n):
        kc, vc = rotate(kc), rotate(vc)
        for i in range(n):
            src = (i - s) % n
            if causal and src > i:
                continue
            outs[i], lses[i] = _lse_merge(outs[i], lses[i],
                                          *attend(i, kc, vc, src))
    return torch.stack(outs).to(q.dtype)
