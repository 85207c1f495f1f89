"""Quantized-weight GEMMs (counterpart of gemma_tpu/ops/matmul.py; the
reference's `CallMatMul` / `TwoMatMul`, ops/matmul-inl.h).

    C[M, N] = scale * (A[M, K] . B[N, K]^T)

with B stored row-major transposed, as in `.sbs` files.  This slice
carries the "i8" codec (codes i8 [N, K] + per-128-group `inv_scales`
and `zeropoints` f32 [N, K/128], dequant = inv * (c - zp)) and the dense
"f32"/"bf16" kinds on the CPU.

Every GEMM has a kernel path and a plain path.  For CUDA tensors the
wrappers launch the hand-written kernels of csrc/matmul_i8.cu (K1 with
its norm prologue and post-norm passes, K2, and K3, the fused greedy
head `matmul_top1`) or raise; for CPU tensors
they take the plain versions below, which compute the same function with
the same group affine applied to the output:
    out += inv_g * (A_g . C_g) - (inv_g * zp_g) * sum(A_g).
"""

from __future__ import annotations

import dataclasses

import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops.ops import rms_norm, soft_cap

GROUP = 128

PRENORM = _cuda.Kernel(
    "matmul_i8_prenorm", "matmul_i8.cu", "gemma_prenorm_bf16",
    [_cuda.P] * 3 + [_cuda.I] * 2)
POSTNORM_ADD = _cuda.Kernel(
    "matmul_i8_postnorm_add", "matmul_i8.cu", "gemma_postnorm_add",
    [_cuda.P] * 4 + [_cuda.I] * 3)
# One C entry runs [prologue norm pass] -> GEMM -> [post-norm + add pass]
# and reports which of them it launched; each is counted on its own Kernel.
MATMUL_I8 = _cuda.Kernel(
    "matmul_i8", "matmul_i8.cu", "gemma_matmul_i8",
    [_cuda.P] * 5 + [_cuda.F] + [_cuda.P] * 5 + [_cuda.I] * 4,
    passes=(PRENORM, POSTNORM_ADD))
GATED_I8 = _cuda.Kernel(
    "gated_i8", "matmul_i8.cu", "gemma_gated_i8",
    [_cuda.P] * 5 + [_cuda.F] + [_cuda.P] * 3 + [_cuda.F]
    + [_cuda.P] * 2 + [_cuda.I] * 3,
    passes=(PRENORM,))
TOP1_I8 = _cuda.Kernel(
    "top1_i8", "matmul_i8.cu", "gemma_top1_i8",
    [_cuda.P] * 5 + [_cuda.F] * 2 + [_cuda.P] + [_cuda.I] + [_cuda.P] * 7
    + [_cuda.I] * 4,
    passes=(PRENORM,))
# K3's blocks per 16 rows: each walks N / (8 * TOP1_BLOCKS) 8-column tiles
# and leaves one online state per row for the last block to merge.  528
# is one wave on an H100 (132 SMs x 4 blocks of 8 warps at 57 registers);
# more blocks lengthen the last block's merge (chip_smoke.py sweeps it).
TOP1_BLOCKS = 528
# One zeroed int per device, counted up by K3's blocks and reset by the
# last one: K3 launches on one device must not overlap (one stream).
_top1_tickets: dict[torch.device, torch.Tensor] = {}


@dataclasses.dataclass
class QuantTensor:
    """A possibly-quantized [N, K] weight matrix on one device.

    kind "i8": arrays codes i8 [N, K], inv_scales / zeropoints f32
    [N, K/128] (the JAX package's layout, which the CUDA kernels read
    as is); kind "f32"/"bf16": arrays w [N, K]."""

    kind: str
    shape: tuple[int, int]
    scale: float
    arrays: dict[str, torch.Tensor]

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Full [N, K] dense decode (tests and the plain path)."""
        if self.kind in ("f32", "bf16"):
            w = self.arrays["w"].float()
        elif self.kind == "i8":
            codes = self.arrays["codes"].float()
            inv, zp = self.arrays["inv_scales"], self.arrays["zeropoints"]
            n, k = codes.shape
            g = inv.shape[1]
            c = codes.view(n, g, k // g)
            w = (inv[:, :, None] * (c - zp[:, :, None])).reshape(n, k)
        else:
            raise ValueError(self.kind)
        if self.scale != 1.0:
            w = w * self.scale
        return w.to(dtype)


def concat_rows(*qts: QuantTensor) -> QuantTensor | None:
    """Row-concatenate same-kind/K/scale tensors: the output of one GEMM
    over the result is the column-concatenation of the parts' outputs (the
    q and kv projections become one GEMM).  None when they cannot merge."""
    first = qts[0]
    if any(q is None for q in qts):
        return None
    if any(q.kind != first.kind or q.k != first.k
           or float(q.scale) != float(first.scale)
           or set(q.arrays) != set(first.arrays) for q in qts):
        return None
    arrays = {key: torch.cat([q.arrays[key] for q in qts], dim=0)
              for key in first.arrays}
    return QuantTensor(first.kind, (sum(q.n for q in qts), first.k),
                       first.scale, arrays)


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the yardstick the kernels are held to).
# ---------------------------------------------------------------------------


def _product_plain(a: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """scale * A . dequant(W)^T in f32, [M, N]."""
    if w.kind in ("f32", "bf16"):
        # B feeds the product at A's dtype, as the TPU kernel's dot does.
        dense = w.arrays["w"].to(a.dtype).float()
        out = a.float() @ dense.T
    elif w.kind == "i8":
        af = a.float()
        m, k = af.shape
        codes = w.arrays["codes"]
        inv, zp = w.arrays["inv_scales"], w.arrays["zeropoints"]
        g_count = k // GROUP
        out = torch.zeros(m, w.n, dtype=torch.float32, device=a.device)
        for g in range(g_count):
            sl = slice(g * GROUP, (g + 1) * GROUP)
            a_g = af[:, sl]
            part = a_g @ codes[:, sl].float().T
            a_sum = a_g.sum(dim=1, keepdim=True)
            inv_g = inv[:, g][None, :]
            out += inv_g * part - (inv_g * zp[:, g][None, :]) * a_sum
    else:
        raise ValueError(w.kind)
    if w.scale != 1.0:
        out = out * w.scale
    return out


def matmul_plain(a, w, out_dtype=torch.float32, add=None, prologue_norm=None,
                 epilogue_norm=None):
    """K1's function in plain PyTorch: out = add + postnorm(scale*A.B^T),
    with A = bf16(rmsnorm(A)) under a prologue (matmul.py:1015-1177)."""
    if prologue_norm is not None:
        a = prenorm_plain(a, prologue_norm)
    out = _product_plain(a, w)
    if epilogue_norm is not None:
        out = rms_norm(out, epilogue_norm)
    if add is not None:
        out = out + add.float()
    return out.to(out_dtype)


def prenorm_plain(a, weight):
    """The K1/K2 prologue in plain PyTorch: bf16(rmsnorm(a)) (_norm_a)."""
    return rms_norm(a.float(), weight).to(torch.bfloat16)


def postnorm_add_plain(y, weight=None, add=None, out_dtype=torch.float32):
    """The K1 epilogue pass in plain PyTorch: add + postnorm(y), f32 math."""
    out = y.float()
    if weight is not None:
        out = rms_norm(out, weight)
    if add is not None:
        out = out + add.float()
    return out.to(out_dtype)


def matmul_top1_plain(a, w, *, final_cap, prologue_norm=None,
                      allowed_mask=None, need_prob=True):
    """K3's function in plain PyTorch (matmul.py:1640-1725): per row, the
    argmax (ties to the lowest index) of softcap(scale * A.B^T) with banned
    columns at -inf, and prob = 1 / max(s, 1e-30), s the sum of
    exp(logit - max).  need_prob=False: argmax of the raw logits, prob 1.
    A row with no allowed column gives token 0."""
    logits = matmul_plain(a, w, prologue_norm=prologue_norm)
    if need_prob:
        logits = soft_cap(final_cap, logits)
    if allowed_mask is not None:
        logits = logits.masked_fill(~allowed_mask.bool(), float("-inf"))
    m = logits.amax(dim=-1)
    empty = m == float("-inf")
    token = torch.where(empty, 0, logits.argmax(dim=-1)).to(torch.int32)
    if not need_prob:
        return token, torch.ones_like(m)
    safe_m = torch.where(empty, 0.0, m)
    s = torch.exp(logits - safe_m[:, None]).sum(dim=-1)
    return token, 1.0 / s.clamp_min(1e-30)


def gated_ffn_plain(x, w1, w2, out_dtype=torch.bfloat16, prologue_norm=None):
    """K2's function in plain PyTorch: gelu_tanh(x.W1^T) * (x.W2^T)."""
    if prologue_norm is not None:
        x = prenorm_plain(x, prologue_norm)
    c1 = _product_plain(x, w1)
    c2 = _product_plain(x, w2)
    arg = c1 * (0.797884560804236 + 0.03567740813636141 * c1 * c1)
    return ((c1 * (0.5 + 0.5 * torch.tanh(arg))) * c2).to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check_i8(w: QuantTensor, name: str) -> None:
    if w.kind != "i8":
        raise NotImplementedError(
            f"{name}: the CUDA GEMMs carry the i8 codec only; the other "
            "codecs (TPU kernel family K7) are a later slice")
    if w.k % GROUP or w.n % 8:
        raise ValueError(f"{name}: K must be a multiple of 128 and N of 8, "
                         f"got {w.shape}")
    _cuda.check(w.arrays["codes"], "codes", torch.int8, w.shape)
    g = (w.n, w.k // GROUP)
    _cuda.check(w.arrays["inv_scales"], "inv_scales", torch.float32, g)
    _cuda.check(w.arrays["zeropoints"], "zeropoints", torch.float32, g)


def _a_operand(a: torch.Tensor, k: int, prologue_norm):
    """(A, norm, scratch) as the kernel takes them: f32 A with a norm and a
    bf16 [M, K] scratch for the normalized rows, else bf16 A."""
    scratch = None
    if prologue_norm is not None:
        _cuda.check(a, "a", torch.float32)
        _cuda.check(prologue_norm, "prologue_norm", torch.float32, (k,))
        scratch = torch.empty(a.shape, dtype=torch.bfloat16, device=a.device)
    else:
        _cuda.check(a, "a", torch.bfloat16)
    if a.ndim != 2 or a.shape[1] != k:
        raise ValueError(f"a must be [M, {k}], got {tuple(a.shape)}")
    return a, prologue_norm, scratch


def _check_epilogue(weight, add, m, n):
    if weight is not None:
        _cuda.check(weight, "epilogue_norm", torch.float32, (n,))
    if add is not None:
        _cuda.check(add, "add", torch.float32, (m, n))


def prenorm(a, weight):
    """bf16(rmsnorm(a)) over whole rows: the prologue pass alone on CUDA."""
    if not a.is_cuda:
        return prenorm_plain(a, weight)
    a, weight, out = _a_operand(a, a.shape[-1], weight)
    PRENORM.launch(a.data_ptr(), weight.data_ptr(), out.data_ptr(),
                   a.shape[0], a.shape[1])
    return out


def postnorm_add(y, weight=None, add=None, out_dtype=torch.float32):
    """add + postnorm(y) over whole rows: the epilogue pass alone on CUDA."""
    if not y.is_cuda:
        return postnorm_add_plain(y, weight, add, out_dtype)
    m, n = y.shape
    _cuda.check(y, "y", torch.float32)
    _check_epilogue(weight, add, m, n)
    out = y if out_dtype == torch.float32 else torch.empty(
        m, n, dtype=out_dtype, device=y.device)
    POSTNORM_ADD.launch(y.data_ptr(), _cuda.ptr(weight), _cuda.ptr(add),
                        out.data_ptr(), m, n, int(out_dtype == torch.bfloat16))
    return out


def matmul(a, w, out_dtype=torch.float32, add=None, prologue_norm=None,
           epilogue_norm=None):
    """C = add + postnorm(scale * A . W^T) (matmul.py:1015-1177).

    prologue_norm: RMSNorm weight [K] applied to A's rows in-kernel (A
    then arrives f32); epilogue_norm: post-RMSNorm weight [N] over the
    output rows; add: [M, N] residual, added after the post-norm."""
    if not a.is_cuda:
        return matmul_plain(a, w, out_dtype, add, prologue_norm,
                            epilogue_norm)
    _check_i8(w, "matmul")
    a, norm, a_scratch = _a_operand(a, w.k, prologue_norm)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}")
    m = a.shape[0]
    post = epilogue_norm is not None or add is not None
    _check_epilogue(epilogue_norm, add, m, w.n)
    out = torch.empty(m, w.n, dtype=out_dtype, device=a.device)
    y = None  # f32 staging of the GEMM output for the epilogue pass
    if post:
        y = out if out_dtype == torch.float32 else torch.empty(
            m, w.n, dtype=torch.float32, device=a.device)
    MATMUL_I8.launch(
        a.data_ptr(), _cuda.ptr(norm), w.arrays["codes"].data_ptr(),
        w.arrays["inv_scales"].data_ptr(), w.arrays["zeropoints"].data_ptr(),
        float(w.scale), _cuda.ptr(epilogue_norm), _cuda.ptr(add),
        _cuda.ptr(a_scratch), _cuda.ptr(y), out.data_ptr(), m, w.n, w.k,
        int(out_dtype == torch.bfloat16))
    return out


def matmul_top1(a, w, *, final_cap, prologue_norm=None, allowed_mask=None,
                need_prob=True):
    """(token int32 [M], prob f32 [M]) = Top1OfSoftmax(softcap(scale *
    A . W^T)) without the [M, N] logits (matmul.py:1640-1725, K3).

    allowed_mask: [N] bool, banned columns leave the argmax and the sum;
    prologue_norm: the final RMSNorm weight [K] (A then arrives f32);
    need_prob=False: raw-logits argmax, prob 1.0."""
    if not a.is_cuda:
        return matmul_top1_plain(a, w, final_cap=final_cap,
                                 prologue_norm=prologue_norm,
                                 allowed_mask=allowed_mask,
                                 need_prob=need_prob)
    _check_i8(w, "matmul_top1")
    a, norm, a_scratch = _a_operand(a, w.k, prologue_norm)
    m = a.shape[0]
    if allowed_mask is not None:
        allowed_mask = allowed_mask.to(torch.bool).contiguous()
        _cuda.check(allowed_mask, "allowed_mask", torch.bool, (w.n,))
    ticket = _top1_tickets.get(a.device)
    if ticket is None:
        ticket = _top1_tickets[a.device] = torch.zeros(
            1, dtype=torch.int32, device=a.device)
    part = torch.empty(2, m, TOP1_BLOCKS, dtype=torch.float32,
                       device=a.device)
    part_i = torch.empty(m, TOP1_BLOCKS, dtype=torch.int32, device=a.device)
    tok = torch.empty(m, dtype=torch.int32, device=a.device)
    prob = torch.empty(m, dtype=torch.float32, device=a.device)
    TOP1_I8.launch(
        a.data_ptr(), _cuda.ptr(norm), w.arrays["codes"].data_ptr(),
        w.arrays["inv_scales"].data_ptr(), w.arrays["zeropoints"].data_ptr(),
        float(w.scale), float(final_cap), _cuda.ptr(allowed_mask),
        int(need_prob), _cuda.ptr(a_scratch), part[0].data_ptr(),
        part[1].data_ptr(), part_i.data_ptr(), ticket.data_ptr(),
        tok.data_ptr(), prob.data_ptr(), m, w.n, w.k, TOP1_BLOCKS)
    return tok, prob


def gated_ffn(x, w1, w2, out_dtype=torch.bfloat16, prologue_norm=None):
    """TwoMatMul analog: gelu_tanh(x . W1^T) * (x . W2^T) in one kernel
    (matmul.py:1789), with an optional pre-FFN norm prologue."""
    if not x.is_cuda:
        return gated_ffn_plain(x, w1, w2, out_dtype, prologue_norm)
    _check_i8(w1, "gated_ffn")
    _check_i8(w2, "gated_ffn")
    if w1.shape != w2.shape:
        raise ValueError(f"gated_ffn: {w1.shape} vs {w2.shape}")
    if out_dtype != torch.bfloat16:
        raise ValueError("gated_ffn emits bf16 on CUDA")
    x, norm, a_scratch = _a_operand(x, w1.k, prologue_norm)
    m = x.shape[0]
    out = torch.empty(m, w1.n, dtype=torch.bfloat16, device=x.device)
    GATED_I8.launch(
        x.data_ptr(), _cuda.ptr(norm),
        w1.arrays["codes"].data_ptr(), w1.arrays["inv_scales"].data_ptr(),
        w1.arrays["zeropoints"].data_ptr(), float(w1.scale),
        w2.arrays["codes"].data_ptr(), w2.arrays["inv_scales"].data_ptr(),
        w2.arrays["zeropoints"].data_ptr(), float(w2.scale),
        _cuda.ptr(a_scratch), out.data_ptr(), m, w1.n, w1.k)
    return out
