"""K4-K6: flash attention (blockwise, online softmax), forward and both
backward kernels, for Hopper.

Counterpart of ``tpu_ddp/ops/flash_attention.py``. Layout ``(B, T, H, D)``,
float32 or bfloat16, as in the JAX package.

* ``reference`` is the plain PyTorch attention (``_reference`` :72), with
  autograd through it: scale ``1/sqrt(D)``, invisible scores set to the
  finite ``NEG``, softmax, then the multiplicative mask, so a row with no
  visible key outputs exactly 0. It is the tests' oracle and the LM's
  plain causal attention (``models/lm.py``).
* Three kernels, K4 in ``csrc/flash_forward.cu`` and K5, K6 in
  ``csrc/flash_attention.cu``, all three with their float32 products on the
  tensor cores in 3xTF32 (``mma.sync``, each operand split into a high and
  a low TF32 part), each with its wrapper (CUDA tensors launch the kernel
  and add one to ``LAUNCHES``; CPU tensors take the plain version; anything
  else raises) and its plain version, which repeats the kernel's
  arithmetic on whole ``(T, T)`` score matrices. ``forward_launch_info``
  and ``backward_launch_info`` report each kernel's tiles, registers,
  shared memory and blocks an SM on the current card:

  ========  ==============  ===============  ============================
  kernel    wrapper         plain            replaces
  ========  ==============  ===============  ============================
  K4        ``flash_forward``  ``forward_plain``  ``_kernel`` :108
  K5        ``flash_dq``       ``dq_plain``       ``_dq_kernel`` :327
  K6        ``flash_dkv``      ``dkv_plain``      ``_dkv_kernel`` :366
  ========  ==============  ===============  ============================

  The row log-sum-exp ``lse`` and ``di = rowsum(dO * O)`` are ``(B, H, T)``
  float32; the TPU's lane-broadcast ``(B*H, T, 128)`` rows and its head-dim
  padding to 128 (``_fold`` :206) are layout of the TPU only.
* ``FlashAttention`` is the ``torch.autograd.Function``: forward K4, saving
  ``q, k, v, out, lse``; backward ``di`` in torch ops (the JAX package
  computes it outside the kernels too, :416), then K5 and K6.

**bfloat16.** q, k, v (and dO) in bfloat16 take each kernel's bfloat16
kernel, counted apart as ``flash_attention_{fwd,dq,dkv}_bf16``, with one
bf16 x bf16 product and float32 accumulators where the float32 kernels make
three TF32 ones. All three are Hopper's tensor-core path: TMA loads into
128-byte-swizzled shared memory, an mbarrier ring and ``wgmma``
(``csrc/flash_wg.cuh``, ``csrc/hopper.cuh``), K4 and K5 with the query rows
resident and the key tiles streamed, K6 the other way, with each query
tile's ``lse`` and ``di`` in the same ring stage. TMA describes an operand
by a tensor map, which needs a 16-byte-aligned base and strides that are
multiples of 16 bytes: ``tma_operand`` hands the kernels each bf16 operand
that ``tma_ready`` as it lies (the ViT's ``qkv`` views and the LM's,
D = 64) and any other as a copy whose rows lie at D rounded up to 8
elements, zero beyond D, viewed back to D (the copy of a ``(B, T, H, 36)``
tensor, say); ``tma_rows`` hands K6 ``lse`` and ``di`` as they lie where T
is a multiple of 4 (the LM's and the ViT's) and otherwise as a copy whose
rows lie at T rounded up to 4, zero beyond T. The kernels read D columns
and take the scale ``1/sqrt(D)`` from that true D. The dtype flow is the JAX
kernels' (:138, :291, :352-354, :391-394, :416-420): S = Q Kᵀ and
dP = dO Vᵀ exact products summed in float32; the running max, the
denominator, ``lse`` and ``di`` float32; ``out``, ``dq``, ``dk`` and ``dv``
rounded to bfloat16 (round to nearest even). Where JAX multiplies the
float32 ``p`` and ``ds`` into a bf16 operand (P V, dS K, Pᵀ dO, dSᵀ Q) it
promotes the bf16 side and the product is float32; here ``p`` and ``ds``
are **rounded to bfloat16** first and the product is one bf16 product
(design (a): the FlashAttention convention, the one the JAX package's own
``full_attention`` takes for p, ``models/vit.py:40``). The accumulator
fragment of S then is, register for register, the A fragment of the next
product, so P never goes through shared memory; the rounding costs up to
2^-9 relative on each p and ds, within the tolerances the tests state. The
denominator ``l`` sums the unrounded p, as the JAX kernel's does. The plain
versions take the same flow, so that the card compares kernel and plain
version in the working type; K4 rounds p against the running max of its
key tile and rescales afterwards, where ``forward_plain`` rounds against
the row's final max, so the two may differ by a rounding of p.

``reference`` keeps the dtype flow of the JAX ``_reference`` (:72-88) on
bfloat16 inputs: the score einsum rounds to bfloat16, the ``np.float64``
scale then promotes the scores to float32, and softmax, P V and the output
stay float32 (a float32 result from bfloat16 inputs).

The kernels serve every ``T >= 1`` and ``D <= 128``: there is no
counterpart of ``_plan``'s fallback to the jnp path for tiny or prime ``T``
(:199-202), of the interpret/shard_map fallback (:260-266), or of the
backward's ``lse is None`` branch (:513-519). ``q``, ``k`` and ``v`` may be
strided views (the ViT's ``qkv`` split): the kernels take each tensor's
batch, token and head strides and need only a unit stride on ``D`` (and,
for the bf16 kernels, TMA's alignment, else ``tma_operand``'s copy).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tpu_ddp_torch.ops import KERNELS, LAUNCHES

FWD, DQ, DKV = "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"
#: the bfloat16 instantiations' launch counts
FWD_BF16, DQ_BF16, DKV_BF16 = FWD + "_bf16", DQ + "_bf16", DKV + "_bf16"
#: the dtypes the kernels take
DTYPES = (torch.float32, torch.bfloat16)

#: finite stand-in for -inf on invisible logits (the JAX package's NEG)
NEG = -1e30
#: the largest head dim the kernels take (their shared-memory tiles)
MAX_HEAD_DIM = 128


# --------------------------------------------------------------------------
# the plain side
# --------------------------------------------------------------------------

def _bhqk_visibility(Tq: int, Tk: int, causal: bool,
                     kv_mask: Optional[torch.Tensor],
                     device: torch.device) -> Optional[torch.Tensor]:
    """``(…, Tq, Tk)``-broadcastable bool visibility for ``(B, H, Tq, Tk)``
    scores, or None when everything is visible (``_bhqk_visibility`` :55)."""
    vis = None
    if causal:
        rows = torch.arange(Tq, device=device)[:, None]
        cols = torch.arange(Tk, device=device)[None, :]
        vis = (cols <= rows)[None, None]
    if kv_mask is not None:
        km = (kv_mask > 0)[:, None, None, :]
        vis = km if vis is None else vis & km
    return vis


def _scores(q: torch.Tensor, k: torch.Tensor, vis: Optional[torch.Tensor],
            rounded: bool = False) -> torch.Tensor:
    """Scaled float32 scores; bfloat16 operands are exact in float32, so
    the sum runs in float32 as the tensor cores' does. ``rounded`` rounds
    the unscaled scores to the inputs' dtype first (``reference``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if rounded:
        s = s.to(q.dtype).float()
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    return s if vis is None else torch.where(vis, s, NEG)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernels form it for ``dtype`` inputs: in
    float32 as it is; in bfloat16 with ``a`` (p or ds) rounded to bfloat16,
    summed in float32 (module docstring) and returned in float32."""
    if dtype == torch.float32:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.to(dtype).float(), b.float())


def reference(q, k, v, causal: bool = False, kv_mask=None) -> torch.Tensor:
    """Plain attention on ``(B, T, H, D)``, the numerics ground truth.
    ``causal`` hides col > row; ``kv_mask`` ``(B, Tk)``, nonzero = attend,
    hides key/value columns. Rows with no visible key output exactly 0.
    bfloat16 inputs give a float32 result (module docstring)."""
    vis = _bhqk_visibility(q.shape[1], k.shape[1], causal, kv_mask, q.device)
    p = torch.softmax(_scores(q, k, vis, rounded=True), dim=-1)
    if vis is not None:
        # all-NEG rows softmax to a uniform row; the multiplicative mask
        # turns them into exact zeros
        p = p * vis
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def _probs(q, k, lse, kv_mask, causal):
    """``p = exp(s - lse)`` under the forward's visibility, invisible
    entries exactly 0 (``_tile_p`` :311)."""
    vis = _bhqk_visibility(q.shape[1], k.shape[1], causal, kv_mask, q.device)
    p = torch.exp(_scores(q, k, vis) - lse[..., None])
    return p if vis is None else p * vis


def forward_plain(q, k, v, kv_mask=None, causal: bool = False):
    """K4's function on whole matrices: ``(out, lse)``; a row with no
    visible key gives ``out = 0`` and ``lse = NEG``. ``out`` in the inputs'
    dtype, ``lse`` float32."""
    vis = _bhqk_visibility(q.shape[1], k.shape[1], causal, kv_mask, q.device)
    s = _scores(q, k, vis)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = p * vis
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    safe_l = torch.where(live, l, 1.0)
    if q.dtype == torch.float32:
        out = torch.einsum("bhqk,bkhd->bqhd", p / safe_l, v)
    else:   # P V on the rounded p, then the division, as K4 does
        o = _product("bhqk,bkhd->bqhd", p, v, q.dtype)
        out = (o / safe_l.squeeze(-1).transpose(1, 2)[..., None]).to(q.dtype)
    lse = torch.where(live, m + torch.log(safe_l), NEG)
    return out, lse[..., 0]


def dq_plain(q, k, v, do, lse, di, kv_mask=None, causal: bool = False):
    """K5's function: ``dq = (p * (dO Vᵀ - di) * scale) K``, in the inputs'
    dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, kv_mask, causal)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - di[..., None]) * scale
    return _product("bhqk,bkhd->bqhd", ds, k, q.dtype).to(q.dtype)


def dkv_plain(q, k, v, do, lse, di, kv_mask=None, causal: bool = False):
    """K6's function: ``(dk, dv) = (dsᵀ Q, pᵀ dO)``, in the inputs' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, kv_mask, causal)
    dv = _product("bhqk,bqhd->bkhd", p, do, q.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - di[..., None]) * scale
    dk = _product("bhqk,bqhd->bkhd", ds, q, q.dtype)
    return dk.to(q.dtype), dv.to(q.dtype)


# --------------------------------------------------------------------------
# the kernel side
# --------------------------------------------------------------------------

def _check(q, k, v, kv_mask, what: str, *more):
    """Shapes, dtype, device and strides that the kernels take."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, T, H, D), got {tuple(q.shape)}")
    B, T, H, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {D} is above the kernels' limit "
                         f"of {MAX_HEAD_DIM}")
    if T < 1 or D < 1:
        raise ValueError(f"{what}: empty attention {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)) + more:
        if tuple(t.shape) != (B, T, H, D):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, q is "
                             f"{tuple(q.shape)} (self-attention shapes only)")
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        if t.dtype not in DTYPES:
            raise ValueError(f"{what}: {name} is {t.dtype}; the kernels take "
                             "float32 or bfloat16 only")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q is {q.dtype} "
                             "(one dtype for q, k, v and dO)")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} lies on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a unit stride on D, got "
                             f"strides {t.stride()}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if kv_mask is not None and (tuple(kv_mask.shape) != (B, T)
                                or kv_mask.dtype != torch.float32
                                or kv_mask.device != q.device
                                or not kv_mask.is_contiguous()):
        raise ValueError(f"{what}: kv_mask must be contiguous float32 (B, T) "
                         f"= {(B, T)} on {q.device}")


def _rows(t: torch.Tensor, B: int, H: int, T: int, what: str) -> None:
    if (tuple(t.shape) != (B, H, T) or t.dtype != torch.float32
            or not t.is_contiguous()):
        raise ValueError(f"{what}: row statistics must be contiguous float32 "
                         f"(B, H, T) = {(B, H, T)}")


def _strides(*tensors) -> ctypes.Array:
    """Batch, token and head strides (elements) of each tensor, in order,
    as the host array the C entry points read."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bfloat16 K4-K6, which load their operands by TMA, can
    describe the ``(B, T, H, D)`` tensor ``t`` by a tensor map as it lies:
    a 16-byte-aligned base; batch, token and head strides that are multiples
    of 16 bytes (8 elements), the head stride the row of D values at least;
    and those strides nested as a packed tensor's are (no two rows
    overlapping). The ViT's ``qkv`` views and the LM's take it at D = 64."""
    B, T, H, D = t.shape
    sb, st, sh, sd = t.stride()
    return (t.data_ptr() % 16 == 0 and sd == 1 and sb % 8 == 0 and st % 8 == 0
            and sh % 8 == 0 and sh >= D and st >= H * sh and sb >= T * st)


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when ``tma_ready``, else a copy with the same values and
    shape whose rows lie at a stride of D rounded up to 8 elements, zero
    beyond D (a contiguous ``(B, T, H, Dp)`` tensor, viewed back to D). The
    kernel reads D columns, so it takes the true D, and the scale
    ``1/sqrt(D)`` with it, from the view."""
    if tma_ready(t):
        return t
    B, T, H, D = t.shape
    padded = t.new_zeros((B, T, H, -(-D // 8) * 8))
    padded[..., :D] = t
    return padded[..., :D]


def tma_rows(t: torch.Tensor) -> torch.Tensor:
    """The contiguous ``(B, H, T)`` float32 row statistics ``t`` (``lse`` or
    ``di``) as the bfloat16 K6 reads them by TMA, rows at a stride of T
    rounded up to 4 (16 bytes): ``t`` itself where T is a multiple of 4,
    else a copy with the same values, zero beyond T, viewed back to T."""
    B, H, T = t.shape
    if T % 4 == 0:
        return t
    padded = t.new_zeros((B, H, -(-T // 4) * 4))
    padded[..., :T] = t
    return padded[..., :T]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn: str, name: str, dtype: torch.dtype, *args) -> None:
    """Launch ``fn`` (its ``_bf16`` entry point and count for bfloat16)."""
    from tpu_ddp_torch.ops import _build

    if dtype == torch.bfloat16:
        fn, name = fn + "_bf16", name + "_bf16"
    lib = _build.load(KERNELS[name]["library"])
    rc = getattr(lib, fn)(*args)
    _build.check(lib, rc, f"{name} launch")
    LAUNCHES[name] += 1


def flash_forward(q, k, v, kv_mask=None, causal: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(out (B, T, H, D), lse (B, H, T))``."""
    _check(q, k, v, kv_mask, "flash_forward")
    if q.device.type == "cpu":
        return forward_plain(q, k, v, kv_mask, causal)
    B, T, H, D = q.shape
    if q.dtype == torch.bfloat16:
        q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch("tpu_ddp_flash_fwd", FWD, q.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_mask), out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out),
            B, T, H, D, int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


_LAUNCH_KEYS = ("query_rows", "key_rows", "threads", "registers", "spill_bytes",
                "smem_bytes", "blocks_per_sm")


def _launch_info(name: str, fn: str, dtype: torch.dtype, *args) -> dict:
    from tpu_ddp_torch.ops import _build

    if dtype == torch.bfloat16:
        fn, name = fn + "_bf16", name + "_bf16"
    lib = _build.load(KERNELS[name]["library"])
    out = (ctypes.c_int * len(_LAUNCH_KEYS))()
    _build.check(lib, getattr(lib, fn)(*args, out), f"{name} launch info")
    return dict(zip(_LAUNCH_KEYS, out))


def forward_launch_info(D: int, dtype: torch.dtype = torch.float32) -> dict:
    """The launch K4 takes for head dim ``D`` and inputs of ``dtype`` on the
    current card: rows of its query and key tiles, threads, registers and
    spilled bytes a thread, dynamic shared memory a block (bytes), and
    resident blocks an SM by the CUDA occupancy calculator."""
    return _launch_info(FWD, "tpu_ddp_flash_fwd_info", dtype, D)


def backward_launch_info(kind: str, D: int, dtype: torch.dtype = torch.float32) -> dict:
    """The launch K5 (``kind="dq"``) or K6 (``kind="dkv"``) takes for head
    dim ``D`` and inputs of ``dtype`` on the current card, with
    ``forward_launch_info``'s keys: K5's block owns the query rows and
    streams the key rows, K6 the other way."""
    which = {"dq": 0, "dkv": 1}[kind]
    return _launch_info(DQ if kind == "dq" else DKV, "tpu_ddp_flash_bwd_info", dtype,
                        which, D)


def flash_dq(q, k, v, do, lse, di, kv_mask=None, causal: bool = False) -> torch.Tensor:
    """K5: ``dq (B, T, H, D)``."""
    _check(q, k, v, kv_mask, "flash_dq", ("do", do))
    B, T, H, D = q.shape
    _rows(lse, B, H, T, "flash_dq")
    _rows(di, B, H, T, "flash_dq")
    if q.device.type == "cpu":
        return dq_plain(q, k, v, do, lse, di, kv_mask, causal)
    if q.dtype == torch.bfloat16:
        q, k, v, do = tma_operand(q), tma_operand(k), tma_operand(v), tma_operand(do)
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    _launch("tpu_ddp_flash_dq", DQ, q.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), _ptr(kv_mask),
            dq.data_ptr(), _strides(q, k, v, do, dq), B, T, H, D, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def flash_dkv(q, k, v, do, lse, di, kv_mask=None, causal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``(dk, dv)``, each ``(B, T, H, D)``."""
    _check(q, k, v, kv_mask, "flash_dkv", ("do", do))
    B, T, H, D = q.shape
    _rows(lse, B, H, T, "flash_dkv")
    _rows(di, B, H, T, "flash_dkv")
    if q.device.type == "cpu":
        return dkv_plain(q, k, v, do, lse, di, kv_mask, causal)
    if q.dtype == torch.bfloat16:
        q, k, v, do = tma_operand(q), tma_operand(k), tma_operand(v), tma_operand(do)
        lse, di = tma_rows(lse), tma_rows(di)
    dk = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    _launch("tpu_ddp_flash_dkv", DKV, q.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), _ptr(kv_mask),
            dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do, dk, dv),
            B, T, H, D, int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


def row_dot(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(dO * O)`` as ``(B, H, T)`` float32, from bfloat16
    operands too (:416-420)."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


class FlashAttention(torch.autograd.Function):
    """Forward K4; backward K5 and K6 (through the wrappers, so CPU tensors
    run the plain versions of the same three steps)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        out, lse = flash_forward(q, k, v, kv_mask, causal)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        g = _unit_last(g)
        di = row_dot(g, out)
        dq = flash_dq(q, k, v, g, lse, di, kv_mask, ctx.causal)
        dk, dv = flash_dkv(q, k, v, g, lse, di, kv_mask, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, kv_mask=None) -> torch.Tensor:
    """(B, T, H, D) attention through ``FlashAttention``: K4
    forward and K5/K6 backward on CUDA tensors, their plain versions on CPU
    tensors. ``causal`` hides
    col > row; ``kv_mask`` ``(B, T)``, nonzero = attend; rows with no visible
    key output exactly 0, with zero gradients.

    The JAX function's ``block_q``, ``block_k`` and ``interpret`` are not
    here: the first two tile the TPU's VMEM and the last runs Pallas in its
    interpreter; the CUDA kernels fix their own tiles. float32 or bfloat16
    inputs, one dtype for all three, give an output of that dtype; a head
    dim above 128, another dtype or mixed dtypes raise ``ValueError``."""
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    return FlashAttention.apply(q, k, v, kv_mask, causal)
