"""Quantized-weight GEMMs (counterpart of gemma_tpu/ops/matmul.py; the
reference's `CallMatMul` / `TwoMatMul`, ops/matmul-inl.h).

    C[M, N] = scale * (A[M, K] . B[N, K]^T)

with B stored row-major transposed, as in `.sbs` files.  The codecs this
port carries (QuantTensor.kind):
  "i8"   codes i8 [N, K] + per-128-group `inv_scales` and `zeropoints`
         f32 [N, K/128], dequant = inv * (c - zp);
  "sfp"  codes u8 [N, K], gemma.cpp's 8-bit switching float, decoded by
         integer arithmetic (`sfp_decode`);
  "nuq"  codes u8 [N, K] of per-element SFP bytes: the same decode;
  "bf16" / "f32"  w [N, K], dense;
  "i4"   codes u8 [N, Kp/2], two 4-bit codes a byte in split halves (byte
         g*128 + j holds elements j [low nibble] and 128 + j [high] of
         256-block g), `scales` and `mins` f32 [N, Kp/128], dequant =
         s * c + m per 128-wide group; Kp = round_up(K, 256);
  "nuq4" codes as i4's, `tables` u8 [N, round_up(Kp/256 * 16, 128)]: 16
         SFP bytes per 256-block, the block's cluster centres; dequant =
         sfp_decode(table[block][code]).
Both 4.5-bit kinds take 0.5625 bytes a weight.

Every GEMM has a kernel path and a plain path.  For CUDA tensors the
wrappers launch the hand-written kernels of csrc/ (K1 with its norm
prologue and post-norm, K2, K3 the fused greedy head `matmul_top1`, K6
the fused top-k head `matmul_topk`, each built once per codec) or raise:
K1 and K2 take the decode tile of matmul_decode.cu at M <= DECODE_ROWS
rows (K split over warps and blocks where the panels alone would not fill
the card: `decode_split`; the norms folded into the one launch) and the
wgmma tile of matmul_sm90.cu above it (prefill; the norms as passes
around it); for CPU tensors they take the plain versions below,
which compute the same function: the B tile becomes bf16 (A's dtype) and
feeds the product, and the group affines are applied to the output:
    i8:  out += inv_g * (A_g . C_g) - (inv_g * zp_g) * sum(A_g)
    i4:  out += s_g * (A_g . C_g) + m_g * sum(A_g).
The kernels take K in whole chunks (K_MULTIPLE); the plain versions
zero-pad A to the packed kinds' Kp, as the TPU kernels do.

Stacked weights (the scan-over-layers decode, engine/scan_decode.py):
`stack_quant_tensors` lays L same-shaped weights into one [L, ...] tensor
(`stacked=True`), and `matmul` / `gated_ffn` take `layer=t` to multiply
by layer t of it: on CUDA the stacked entries of K1 and K2 (K12) read the
layer index from the device and offset their B pointers by one layer (the
prefill tile: address it as the third coordinate of its tensor maps), so
no layer is copied; on the CPU `take_layer` cuts the layer out and the
plain versions run on it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops.ops import rms_norm, soft_cap
from gemma_tpu_torch.utils.basics import resolve_device, round_up

GROUP = 128
PACK_BLOCK = 256  # the packed kinds' K block: 128 bytes of two nibbles
KINDS = ("i8", "sfp", "nuq", "bf16", "f32", "i4", "nuq4")
PACKED_KINDS = ("i4", "nuq4")
# The kernels' codec of each kind (nuq's device bytes are SFP bytes), and
# what K must be a multiple of: the kernels walk K in chunks of 2 x 64
# bytes per row, a group for i8, a 256-block for the packed kinds.
_CODEC = {"i8": "i8", "sfp": "sfp", "nuq": "sfp", "bf16": "bf16",
          "f32": "f32", "i4": "i4", "nuq4": "nuq4"}
K_MULTIPLE = {"i8": 128, "sfp": 128, "bf16": 64, "f32": 32, "i4": 256,
              "nuq4": 256}
MAX_TOPK = 128  # K6's list per row; above it the head is composed

SOURCE = "matmul.cu"
DECODE_SOURCE = "matmul_decode.cu"
SM90_SOURCE = "matmul_sm90.cu"
# K1 and K2 at M <= DECODE_ROWS run matmul_decode.cu's decode tile (whose
# entries refuse more rows), above it matmul_sm90.cu's prefill tile.
DECODE_ROWS = 16
# The decode tile: a warp multiplies DECODE_WARP_COLS[gated] output
# columns (16 weight rows; K2 8 of each gate) by all M rows, walking K in
# chunks of 128 bytes a weight row (CHUNK[codec] elements); a block of 8
# warps puts `kw` warps on each of 8 / kw row groups, splitting K, and
# `splits` blocks of one thread-block cluster split the K of a panel
# further.  decode_split chooses both from the shapes alone, never from
# M, so that a row's sums are taken in the same order at every batch: a
# block stages its K slice of A in shared memory, at most DECODE_SLICE K
# (72 KB at 8 rows), and one wave is DECODE_WAVE blocks: three of 256
# threads on each of an H100's 132 SMs (the kernels' launch bounds at M <=
# 8).
DECODE_WARP_COLS = {False: 16, True: 8}
DECODE_WAVE = 3 * 132
DECODE_MAX_SPLITS = 8
DECODE_SLICE = 4608
CHUNK = {"i8": 128, "sfp": 128, "bf16": 64, "f32": 32, "i4": 256,
         "nuq4": 256}
PRENORM = _cuda.Kernel(
    "matmul_prenorm", SOURCE, "gemma_prenorm_bf16",
    [_cuda.P] * 3 + [_cuda.I] * 2)
POSTNORM_ADD = _cuda.Kernel(
    "matmul_postnorm_add", SOURCE, "gemma_postnorm_add",
    [_cuda.P] * 4 + [_cuda.I] * 3)
# K6's second kernel, the selection: per row, the k_top best of each slice
# of TOPK_SLICE entries, then of the slices' lists (matmul.cu:
# topk_merge_kernel).  Alone (its own C entry) it merges given lists:
# part_v, part_i, vals, idxs; M, blocks, k_top; scratch_v, scratch_i,
# tickets; slices.
TOPK_MERGE = _cuda.Kernel(
    "topk_merge", SOURCE, "gemma_topk_merge",
    [_cuda.P] * 4 + [_cuda.I] * 3 + [_cuda.P] * 3 + [_cuda.I])
# Entries a block of the selection takes (matmul.cu:kSelSlice), and the
# most list entries (slices x k_top) the row's last block merges
# (kSelMaxMerge).
TOPK_SLICE = 4096
TOPK_MAX_MERGE = 8192


def _b_args(codec: str) -> list:
    """The C types of one B operand: codes, then inv/zp (i8), scales/mins
    (i4) or tables and their row stride (nuq4), then the tensor scale."""
    side = [_cuda.P, _cuda.I] if codec == "nuq4" else [_cuda.P] * 2
    return [_cuda.P] + side + [_cuda.F]


# The decode entries of K1 and K2 (M <= DECODE_ROWS) are one launch each:
# the prologue norm and the post-norm + residual add run inside the
# kernel.  One set of entries per codec, so the counts tell the kinds
# apart.  They take, after the B operands (and K12's layer pointer), the
# split of K: warps a row group, blocks a cluster; K1 then the epilogue's
# weights, add, y, slots and ticket (_device_scratch).
_SPLIT = [_cuda.I, _cuda.I]
_EPILOGUE = [_cuda.P] * 5
MATMUL = {c: _cuda.Kernel(
    f"matmul_{c}", DECODE_SOURCE, f"gemma_matmul_{c}",
    [_cuda.P] * 2 + _b_args(c) + _SPLIT + _EPILOGUE + [_cuda.P]
    + [_cuda.I] * 4) for c in K_MULTIPLE}
GATED = {c: _cuda.Kernel(
    f"gated_{c}", DECODE_SOURCE, f"gemma_gated_{c}",
    [_cuda.P] * 2 + _b_args(c) + _b_args(c) + _SPLIT + [_cuda.P]
    + [_cuda.I] * 3) for c in K_MULTIPLE}
# K12: K1 and K2 on layer `layer` of a stacked weight.  The same C entry
# layout with one more pointer after the B operands: the device int32
# layer index.
MATMUL_STACKED = {c: _cuda.Kernel(
    f"matmul_stacked_{c}", DECODE_SOURCE, f"gemma_matmul_stacked_{c}",
    [_cuda.P] * 2 + _b_args(c) + [_cuda.P] + _SPLIT + _EPILOGUE + [_cuda.P]
    + [_cuda.I] * 4) for c in K_MULTIPLE}
GATED_STACKED = {c: _cuda.Kernel(
    f"gated_stacked_{c}", DECODE_SOURCE, f"gemma_gated_stacked_{c}",
    [_cuda.P] * 2 + _b_args(c) + _b_args(c) + [_cuda.P] + _SPLIT
    + [_cuda.P] + [_cuda.I] * 3) for c in K_MULTIPLE}
# K1 and K2 at M > DECODE_ROWS (prefill), plain or stacked: the stacked
# entries' layout with the layer pointer (None when plain) followed by the
# number of layers.
MATMUL_SM90 = {c: _cuda.Kernel(
    f"matmul_sm90_{c}", SM90_SOURCE, f"gemma_matmul_sm90_{c}",
    [_cuda.P] * 2 + _b_args(c) + [_cuda.P, _cuda.I] + [_cuda.P] * 5
    + [_cuda.I] * 4,
    passes=(PRENORM, POSTNORM_ADD)) for c in K_MULTIPLE}
GATED_SM90 = {c: _cuda.Kernel(
    f"gated_sm90_{c}", SM90_SOURCE, f"gemma_gated_sm90_{c}",
    [_cuda.P] * 2 + _b_args(c) + _b_args(c) + [_cuda.P, _cuda.I]
    + [_cuda.P] * 2 + [_cuda.I] * 3,
    passes=(PRENORM,)) for c in K_MULTIPLE}
# K3: one launch, the final norm folded in (matmul.cu:top1_body).
TOP1 = {c: _cuda.Kernel(
    f"top1_{c}", SOURCE, f"gemma_top1_{c}",
    [_cuda.P] * 2 + _b_args(c) + [_cuda.F] + [_cuda.P] + [_cuda.I]
    + [_cuda.P] * 6 + [_cuda.I] * 4) for c in K_MULTIPLE}
# K6: K3's stream writing the capped logits [M, N] (the final norm folded
# in), then the selection; after the B operand: cap, mask, k_top, the
# logits, part_v, part_i, tickets, vals, idxs; M, N, K, blocks, slices.
TOPK = {c: _cuda.Kernel(
    f"topk_{c}", SOURCE, f"gemma_topk_{c}",
    [_cuda.P] * 2 + _b_args(c) + [_cuda.F] + [_cuda.P] + [_cuda.I]
    + [_cuda.P] * 6 + [_cuda.I] * 5,
    passes=(TOPK_MERGE,)) for c in K_MULTIPLE}
# K3's blocks per 16 rows at most (the capacity of its part_* scratch):
# the kernel launches as many as fit on the card at once, up to this and
# one per 8 row groups of 16 vocabulary rows (two 256-thread blocks on
# each of an H100's 132 SMs: 264); each leaves one online state per row
# for the last block to merge.
TOP1_BLOCKS = 528
# K6's head blocks per 16 rows at most, as K3's (chip_smoke.py sweeps it).
TOPK_BLOCKS = 528
# Per device: zeroed int32 tickets, counted up by the blocks of K3 and of a
# decode K1 under a post-norm (the first) and of K6's selection (one a
# row), each reset by its launch's last block; and that K1's partial sums
# of squares ([blocks, M] f32).  Launches that use them must not overlap:
# one stream per device.
_scratch: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
_TICKETS = 64


def _device_scratch(device, floats: int = 0, tickets: int = 1):
    """(tickets, slots) of `device`: at least `tickets` tickets and
    `floats` slots."""
    got = _scratch.get(device)
    if got is None or got[1].numel() < floats or got[0].numel() < tickets:
        ticket = got[0] if got is not None and got[0].numel() >= tickets \
            else torch.zeros(max(tickets, _TICKETS), dtype=torch.int32,
                             device=device)
        slots = got[1] if got is not None and got[1].numel() >= floats \
            else torch.empty(max(floats, DECODE_WAVE * DECODE_ROWS),
                             dtype=torch.float32, device=device)
        got = _scratch[device] = (ticket, slots)
    return got


def sfp_decode(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """SFP bytes (u8) -> values, bit for bit gemma_tpu/compression/sfp.py:
    decode_jax: sign = bit 7; v = low 7 bits; bf16 bits 0x3400 + 32 v for
    v < 64, 0x3800 + 16 v otherwise, 0 for v = 0 (byte 0x80 is -0.0)."""
    c = codes.to(torch.int32)
    v = c & 0x7F
    mag = torch.where(v < 64, 0x3400 + (v << 5), 0x3800 + (v << 4))
    mag = torch.where(v == 0, torch.zeros_like(mag), mag)
    bits = mag | ((c & 0x80) << 8)
    # bf16 bits as the high half of an f32 word (exact).
    return (bits << 16).view(torch.float32).to(dtype)


def pack_nuq4(codes: np.ndarray) -> np.ndarray:
    """u8 [N, K] 4-bit codes -> split-halves packed u8 [N, Kp/2], Kp =
    round_up(K, 256), padding codes 0: byte g*128 + j holds elements j
    (low nibble) and 128 + j (high) of 256-block g
    (gemma_tpu/ops/matmul.py:_pack_nuq4)."""
    n, k = codes.shape
    kp = round_up(k, PACK_BLOCK)
    c = np.zeros((n, kp), np.uint8)
    c[:, :k] = codes
    c = c.reshape(n, kp // PACK_BLOCK, 2, 128)
    return (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(n, kp // 2)


def unpack_nuq4(packed: torch.Tensor) -> torch.Tensor:
    """Packed u8 [..., Kp/2] -> int32 [..., Kp] codes (pack_nuq4's
    inverse; gemma_tpu/ops/matmul.py:_unpack_nuq4)."""
    lead, half = packed.shape[:-1], packed.shape[-1]
    p = packed.to(torch.int32).reshape(*lead, half // 128, 128)
    return torch.stack([p & 15, p >> 4], dim=-2).reshape(*lead, half * 2)


def nuq4_gather(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The table entries of int32 codes [..., Kp]: column k looks up entry
    (k // 256) * 16 + code of `tables` [..., >= Kp/256 * 16]."""
    kp = codes.shape[-1]
    block = torch.arange(kp, device=codes.device) // PACK_BLOCK
    return torch.gather(tables, -1, (codes + block * 16).long())


@dataclasses.dataclass
class QuantTensor:
    """A possibly-quantized [N, K] weight matrix on one device.

    kind "i8": arrays codes i8 [N, K], inv_scales / zeropoints f32
    [N, K/128]; kind "sfp"/"nuq": arrays codes u8 [N, K]; kind
    "f32"/"bf16": arrays w [N, K]; kind "i4": codes u8 [N, Kp/2], scales /
    mins f32 [N, Kp/128]; kind "nuq4": codes u8 [N, Kp/2], tables u8
    [N, round_up(Kp/16, 128)] (the JAX package's layouts, which the CUDA
    kernels read as they are).

    stacked: the arrays carry a leading [L] dim of layers, and i8 / i4
    group arrays are [L, K/128, N] (`stack_quant_tensors`); `shape` is
    one layer's."""

    kind: str
    shape: tuple[int, int]
    scale: float
    arrays: dict[str, torch.Tensor]
    stacked: bool = False

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
        elif self.kind in ("sfp", "nuq"):
            w = sfp_decode(self.arrays["codes"])
        elif self.kind == "i8":
            codes = self.arrays["codes"].float()
            inv, zp = self.arrays["inv_scales"], self.arrays["zeropoints"]
            n, k = codes.shape
            g = inv.shape[1]
            c = codes.view(n, g, k // g)
            w = (inv[:, :, None] * (c - zp[:, :, None])).reshape(n, k)
        elif self.kind == "i4":
            codes = unpack_nuq4(self.arrays["codes"]).float()
            sc, mn = self.arrays["scales"], self.arrays["mins"]
            n, kp = codes.shape
            g = sc.shape[1]
            c = codes.view(n, g, kp // g)
            w = (sc[:, :, None] * c + mn[:, :, None]).reshape(n, kp)
            w = w[:, :self.k]
        elif self.kind == "nuq4":
            codes = unpack_nuq4(self.arrays["codes"])[:, :self.k]
            w = nuq4_gather(sfp_decode(self.arrays["tables"]), codes)
        else:
            raise unknown_kind(self.kind)
        if self.scale != 1.0:
            w = w * self.scale
        return w.to(dtype)

    @property
    def kp(self) -> int:
        """The K the arrays store: padded to whole 256-blocks when packed."""
        return round_up(self.k, PACK_BLOCK) if self.kind in PACKED_KINDS \
            else self.k

    def data(self) -> torch.Tensor:
        """The [N, K] array the kernels read: codes or dense w."""
        return self.arrays["w" if self.kind in ("f32", "bf16") else "codes"]


def unknown_kind(kind: str) -> Exception:
    return ValueError(f"weight kind {kind!r}: one of {KINDS}")


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


# The per-(row, group) arrays of the affine kinds, transposed to [L, G, N]
# when stacked (the stacked kernels read them so).
_GROUP_KEYS = ("inv_scales", "zeropoints", "scales", "mins")


def stack_quant_tensors(qts: list[QuantTensor]) -> QuantTensor:
    """L same-kind, same-shape weights as one stacked [L, ...] tensor
    (gemma_tpu/ops/matmul.py:183-229): i8 and i4 group arrays transposed
    to [L, G, N]; f32 and bf16 tensor scales folded into the weights (one
    more rounding for bf16); the other kinds must share one tensor scale.
    Raises ValueError when kind, shape, scale or array keys differ."""
    base = qts[0]
    kind = base.kind
    if kind in ("f32", "bf16"):
        def fold(q):
            if q.scale == 1.0:
                return q
            w = q.arrays["w"]
            w = (w.float() * float(np.float32(q.scale))).to(w.dtype)
            return QuantTensor(q.kind, q.shape, 1.0, {"w": w})

        qts = [fold(q) for q in qts]
        base = qts[0]
    for q in qts[1:]:
        if (q.kind, tuple(q.shape), float(q.scale), sorted(q.arrays)) != (
                kind, tuple(base.shape), float(base.scale),
                sorted(base.arrays)):
            raise ValueError(
                f"cannot stack: layer aux differs ({q.kind}/{q.shape}/"
                f"{q.scale} vs {kind}/{base.shape}/{base.scale}); load "
                "with kind_override 'i8' or 'i4' (scale-normalized "
                "transcodes)")
    arrays = {}
    for key in base.arrays:
        st = torch.stack([q.arrays[key] for q in qts])
        if kind in ("i4", "i8") and key in _GROUP_KEYS:
            st = st.transpose(1, 2).contiguous()  # [L, N, G] -> [L, G, N]
        arrays[key] = st
    return QuantTensor(kind, tuple(base.shape), base.scale, arrays,
                       stacked=True)


def take_layer(w: QuantTensor, layer: int) -> QuantTensor:
    """Layer `layer` of a stacked weight as a plain one, the group arrays
    transposed back (gemma_tpu/ops/matmul.py:264-279): a copy, the plain
    path's way to the layer."""
    if not w.stacked:
        raise ValueError("take_layer needs a stacked weight")
    arrays = {}
    for key, a in w.arrays.items():
        sl = a[layer]
        if w.kind in ("i4", "i8") and key in _GROUP_KEYS:
            sl = sl.T
        arrays[key] = sl.contiguous()
    return QuantTensor(w.kind, w.shape, w.scale, arrays)


def _check_layer(w: QuantTensor, layer, name: str) -> None:
    """A stacked weight needs `layer`, a plain one must not get it."""
    if layer is None and w.stacked:
        raise ValueError(f"{name}: a stacked weight needs layer=")
    if layer is not None:
        if not w.stacked:
            raise ValueError(f"{name}: layer= needs a stacked weight "
                             "(stack_quant_tensors)")
        n_layers = w.data().shape[0]
        if not 0 <= layer < n_layers:
            raise ValueError(f"{name}: layer {layer} of {n_layers}")


# One int32 arange per (device, L): the stacked kernels read their layer
# index from it, so a decode step makes no host-to-device copy per layer.
_layer_ids: dict[tuple[torch.device, int], torch.Tensor] = {}


def _layer_ptr(w: QuantTensor, layer: int, device) -> int:
    n_layers = w.data().shape[0]
    ids = _layer_ids.get((device, n_layers))
    if ids is None:
        ids = _layer_ids[(device, n_layers)] = torch.arange(
            n_layers, dtype=torch.int32, device=device)
    return ids.data_ptr() + 4 * layer


@functools.lru_cache(maxsize=None)
def decode_split(n: int, k: int, codec: str,
                 gated: bool) -> tuple[int, int]:
    """(kw, splits) of the decode tile for a GEMM by [n, k] weights:
    splits, the blocks that share a panel's K (a cluster), is the least
    power of two that keeps a block's slice of K within DECODE_SLICE (at
    most DECODE_MAX_SPLITS, at most the chunks of K); kw, the warps that
    share a row group's K in a block, is the largest of 1, 2, 4, 8 that
    keeps panels x splits within a wave (DECODE_WAVE), narrowing the panel
    where N alone would not fill the card."""
    chunks = k // CHUNK[codec]
    per_block = max(1, DECODE_SLICE // CHUNK[codec])
    splits = 1
    while (splits < DECODE_MAX_SPLITS and 2 * splits <= chunks
           and splits * per_block < chunks):
        splits *= 2
    kw = 1
    while kw < 8:
        cols = DECODE_WARP_COLS[gated] * (8 // (2 * kw))
        if -(-n // cols) * splits > DECODE_WAVE:
            break
        kw *= 2
    return kw, splits


def split_chunks(chunks: int, splits: int) -> list[tuple[int, int]]:
    """The chunk range [c0, c1) of each of `splits` parts of `chunks`, as
    the kernel splits K over a cluster's blocks and a block's slice over
    its warps."""
    return [(s * chunks // splits, (s + 1) * chunks // splits)
            for s in range(splits)]


def _gemm_kernel(m: int, w: QuantTensor, layer, device, decode: dict,
                 stacked: dict, sm90: dict, gated: bool):
    """The K1 / K2 entry for M = m rows of A, and the arguments it takes
    after the B operands: the prefill tile's (layer pointer or None, the
    number of layers) above DECODE_ROWS, else the decode tile's (K12's
    layer pointer, then the split of K: kw, splits)."""
    codec = _CODEC[w.kind]
    if m > DECODE_ROWS:
        if layer is None:
            return sm90[codec], (None, 1)
        return sm90[codec], (_layer_ptr(w, layer, device),
                             w.data().shape[0])
    split = decode_split(w.n, w.k, codec, gated)
    if layer is None:
        return decode[codec], split
    return stacked[codec], (_layer_ptr(w, layer, device),) + split


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def quant_tensor_i4(values: np.ndarray, device=None) -> QuantTensor:
    """Encode an f32 [N, K] matrix into the i4 affine device layout
    (gemma_tpu/ops/matmul.py:quant_tensor_i4), on `device` (CUDA unless
    the caller names one)."""
    from gemma_tpu_torch.compression import int4 as int4_codec

    device = resolve_device(device)
    n, k = values.shape
    codes, scales, mins = int4_codec.encode_affine(values)
    return QuantTensor("i4", (n, k), 1.0, {
        "codes": _on(pack_nuq4(codes), device), "scales": _on(scales, device),
        "mins": _on(mins, device)})


def quant_tensor_from_packed(pt, kind: str | None = None,
                             device=None) -> QuantTensor:
    """A QuantTensor on `device` (CUDA unless the caller names one) from a
    compression.PackedTensor, as gemma_tpu/ops/matmul.py builds it: in the
    stream's own kind, or transcoded to `kind`: "i8" and "i4" from any
    stream type (decoded to f32 and re-encoded per 128-group), "nuq4" from
    a NUQ stream (codes nibble-packed, tables re-encoded to their exact SFP
    bytes and padded to a multiple of 128 a row), "bf16" from any."""
    from gemma_tpu_torch.compression import Type
    from gemma_tpu_torch.compression import int8 as int8_codec
    from gemma_tpu_torch.compression import nuq as nuq_codec
    from gemma_tpu_torch.compression import sfp as sfp_codec

    device = resolve_device(device)
    kind = kind or {Type.F32: "f32", Type.BF16: "bf16", Type.SFP: "sfp",
                    Type.NUQ: "nuq", Type.I8: "i8"}[pt.type]
    n, k = pt.rows, pt.cols
    if kind == "f32":
        w = pt.to_f32() / np.float32(pt.scale)
        return QuantTensor("f32", (n, k), pt.scale, {"w": _on(w, device)})
    if kind == "bf16":
        if pt.type == Type.BF16:
            bits = pt.data.view(np.int16).reshape(n, k)
            w = _on(bits, device).view(torch.bfloat16)
        else:  # decode-to-bf16 mode for any packed type (kReadBF16)
            w = _on(pt.to_f32() / np.float32(pt.scale), device).to(
                torch.bfloat16)
        return QuantTensor("bf16", (n, k), pt.scale, {"w": w})
    if kind == "sfp":
        if pt.type != Type.SFP:
            raise ValueError(f"kind 'sfp' from a {pt.type.name} stream")
        return QuantTensor("sfp", (n, k), pt.scale,
                           {"codes": _on(pt.data.reshape(n, k), device)})
    if kind in ("nuq", "nuq4") and pt.type != Type.NUQ:
        raise ValueError(f"kind {kind!r} from a {pt.type.name} stream")
    if kind == "nuq":
        codes = nuq_codec.to_sfp_codes(pt.data, n, k)
        return QuantTensor("nuq", (n, k), pt.scale,
                           {"codes": _on(codes, device)})
    if kind == "nuq4":
        tables, codes = nuq_codec.to_device_layout(pt.data, n, k)
        # Centres are SFP-valued (nuq-inl.h:649-651), so
        # encode(decode(x)) == x bit for bit.
        tbytes = sfp_codec.encode(tables.reshape(-1)).reshape(n, -1)
        tpad = np.zeros((n, round_up(tbytes.shape[1], 128)), np.uint8)
        tpad[:, :tbytes.shape[1]] = tbytes
        return QuantTensor("nuq4", (n, k), pt.scale, {
            "codes": _on(pack_nuq4(codes), device),
            "tables": _on(tpad, device)})
    if kind == "i4":
        return quant_tensor_i4(pt.to_f32().reshape(n, k), device)
    if kind == "i8":
        stream, scale = pt.data, pt.scale
        if pt.type != Type.I8:
            stream, scale = int8_codec.encode(pt.to_f32().reshape(-1)), 1.0
        codes, inv_scales, zp = int8_codec.to_device_layout(stream, n, k)
        return QuantTensor("i8", (n, k), scale, {
            "codes": _on(codes, device), "inv_scales": _on(inv_scales, device),
            "zeropoints": _on(zp, device)})
    raise unknown_kind(kind)


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the yardstick the kernels are held to).
# ---------------------------------------------------------------------------


def _product_plain(a: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """scale * A . dequant(W)^T in f32, [M, N]."""
    if w.kind in ("f32", "bf16"):
        # B feeds the product at A's dtype, as the TPU kernel's dot does.
        dense = w.arrays["w"].to(a.dtype).float()
        out = a.float() @ dense.T
    elif w.kind in ("sfp", "nuq"):
        # Decoded to bf16 exactly, then cast to A's dtype (a no-op for the
        # bf16 and f32 A the port uses).
        dense = sfp_decode(w.arrays["codes"], torch.bfloat16)
        out = a.float() @ dense.to(a.dtype).float().T
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
    elif w.kind == "i4":
        # Raw codes feed the product (exact in bf16); the group affine
        # lands on the output.  A is zero-padded to Kp: padding codes are
        # 0 and a padded group's min multiplies a zero sum.
        af = F.pad(a.float(), (0, w.kp - w.k))
        codes = unpack_nuq4(w.arrays["codes"]).float()
        sc, mn = w.arrays["scales"], w.arrays["mins"]
        out = torch.zeros(af.shape[0], w.n, dtype=torch.float32,
                          device=a.device)
        for g in range(w.kp // GROUP):
            sl = slice(g * GROUP, (g + 1) * GROUP)
            a_g = af[:, sl]
            part = a_g @ codes[:, sl].T
            a_sum = a_g.sum(dim=1, keepdim=True)
            out += sc[:, g][None, :] * part + mn[:, g][None, :] * a_sum
    elif w.kind == "nuq4":
        # Each code looks its 256-block's table up; the entries are SFP
        # bytes, exact in bf16, and feed the product at A's dtype.
        tables = sfp_decode(w.arrays["tables"], torch.bfloat16)
        dense = nuq4_gather(tables, unpack_nuq4(w.arrays["codes"]))
        af = F.pad(a.float(), (0, w.kp - w.k))
        out = af @ dense.to(a.dtype).float().T
    else:
        raise unknown_kind(w.kind)
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
    """The prologue norm in plain PyTorch: bf16(rmsnorm(a)) (_norm_a); the
    plain version of the prologue pass (the prefill tile's) and of the
    prologue folded into the decode tile, K3 and K6."""
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


def matmul_topk_plain(a, w, k_top, *, final_cap=0.0, prologue_norm=None,
                      allowed_mask=None):
    """K6's function in plain PyTorch (matmul.py:_topk_kernel): per row the
    k_top largest of softcap(scale * A.B^T), banned columns at -inf, as
    (values f32, indices int32) [M, k_top], descending, ties to the lower
    index; entries past the live columns are (-inf, index 0), as the TPU
    kernel leaves them."""
    logits = soft_cap(final_cap, matmul_plain(a, w,
                                              prologue_norm=prologue_norm))
    if allowed_mask is not None:
        logits = logits.masked_fill(~allowed_mask.bool(), float("-inf"))
    vals, idxs = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idxs = vals[:, :k_top], idxs[:, :k_top]
    idxs = torch.where(vals == float("-inf"), 0, idxs)
    return vals.contiguous(), idxs.to(torch.int32).contiguous()


def topk_merge_plain(part_v, part_i, k_top):
    """K6's merge pass in plain PyTorch: the k_top first of each row's
    [blocks, k] (value, index) pairs by (value descending, index
    ascending); dead entries (-inf) leave with index 0."""
    m = part_v.shape[0]
    v, i = part_v.reshape(m, -1), part_i.reshape(m, -1).long()
    order = torch.sort(i, dim=-1, stable=True).indices
    v, i = v.gather(-1, order), i.gather(-1, order)
    vals, order = torch.sort(v, dim=-1, descending=True, stable=True)
    vals, idxs = vals[:, :k_top], i.gather(-1, order)[:, :k_top]
    idxs = torch.where(vals == float("-inf"), 0, idxs)
    return vals.contiguous(), idxs.to(torch.int32).contiguous()


def gated_ffn_plain(x, w1, w2, out_dtype=torch.bfloat16, prologue_norm=None):
    """K2's function in plain PyTorch: gelu_tanh(x.W1^T) * (x.W2^T)."""
    if prologue_norm is not None:
        x = prenorm_plain(x, prologue_norm)
    c1 = _product_plain(x, w1)
    c2 = _product_plain(x, w2)
    arg = c1 * (0.797884560804236 + 0.03567740813636141 * c1 * c1)
    return ((c1 * (0.5 + 0.5 * torch.tanh(arg))) * c2).to(out_dtype)


# ---------------------------------------------------------------------------
# The kernels' orders of summation and merging, in plain PyTorch: what the
# folded prologue and epilogue of the decode tile and K3 compute, step by
# step as the kernels take them (the CPU tests hold these against the JAX
# package, and chip_smoke.py holds the folded prologue to
# prenorm_fixed_order bit for bit; no serving path calls them).  The f32 operations are the
# kernels' own, but for the tie-and-sum merges of K3, whose multiply-adds
# the compiler may fuse.
# ---------------------------------------------------------------------------

NORM_SEG = 32  # gemm_common.cuh:kNormSeg, K of one partial sum of squares
_INT_MAX = 2 ** 31 - 1


def lane_sums(x: torch.Tensor) -> torch.Tensor:
    """A warp's f32 sum of x [R, n] along n in the kernels' order: lane l
    adds x[:, l], x[:, l + 32], ... in turn from 0, then the 32 lanes meet
    in a butterfly (xor 16, 8, 4, 2, 1; gemm_common.cuh's norm_row_mul,
    post_partials and post_tail).  Returns [R]."""
    r, n = x.shape
    x = F.pad(x.float(), (0, (-n) % 32)).reshape(r, -1, 32)
    s = torch.zeros(r, 32, dtype=torch.float32, device=x.device)
    for i in range(x.shape[1]):
        s = s + x[:, i]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ o]
    return s[:, 0]


def _fma(a, b, c):
    """f32 round(a * b + c), the kernels' __fmaf_rn (the product of two
    f32 is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def norm_multiplier(a: torch.Tensor, k: int) -> torch.Tensor:
    """The folded prologue's multiplier of each row of f32 a [M, >= k]
    (zeros past the logical k): 1 / sqrt(ss / k + 1e-6), ss the sum of
    squares in gemm_common.cuh's order: per segment of NORM_SEG K, 8 lanes
    of 4 consecutive K, ((x0^2 + x1^2) + x2^2) + x3^2 each, meeting in a
    butterfly (xor 4, 2, 1); the segment sums then as `lane_sums` adds
    them (zero segments past k change nothing).  Returns [M]."""
    a = a.float()
    m, kp = a.shape
    sq = F.pad(a, (0, (-kp) % NORM_SEG)).reshape(m, -1, 8, 4) ** 2
    lane = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3]
    j = torch.arange(8, device=a.device)
    for o in (4, 2, 1):
        lane = lane + lane[..., j ^ o]
    ss = lane_sums(lane[..., 0])
    return 1.0 / torch.sqrt(ss / k + 1e-6)


def prenorm_fixed_order(a, weight, k: int | None = None):
    """The prologue folded into the decode tile and K3: bf16(m + m * w),
    one multiply-add, m = a * norm_multiplier(a, k); k the logical K
    (default a's width; a and weight are zero past it)."""
    a = a.float()
    mul = norm_multiplier(a, a.shape[1] if k is None else k)[:, None]
    m = a * mul
    return _fma(m, weight.float(), m).to(torch.bfloat16)


def decode_blocks(n: int, kw: int, splits: int) -> list[tuple[int, int]]:
    """The decode tile's blocks of K1 over N output columns, in the order
    the folded post-norm adds their partial sums (panel, then rank in the
    cluster), each as its column range [lo, hi) clipped to N; (kw, splits)
    as decode_split gives them."""
    pc = DECODE_WARP_COLS[False] * (8 // kw)
    out = []
    for panel in range(-(-n // pc)):
        for r in range(splits):
            lo = panel * pc + r * pc // splits
            hi = panel * pc + (r + 1) * pc // splits
            out.append((min(lo, n), min(hi, n)))
    return out


def postnorm_add_blocks(y, weight, add=None, split=(8, 1),
                        out_dtype=torch.float32):
    """The post-norm + residual epilogue folded into the decode tile, on the
    raw f32 product y [M, N]: every block's partial sum of squares of its
    columns (decode_blocks at split = (kw, splits)) by `lane_sums`, the
    blocks' partials by `lane_sums` again; then add + (m + m * w), m = y *
    1 / sqrt(ss / N + 1e-6)."""
    y = y.float()
    n = y.shape[1]
    parts = torch.stack([lane_sums(y[:, lo:hi] * y[:, lo:hi])
                         for lo, hi in decode_blocks(n, *split)], dim=1)
    mul = (1.0 / torch.sqrt(lane_sums(parts) / n + 1e-6))[:, None]
    m = y * mul
    out = _fma(m, weight.float(), m)
    if add is not None:
        out = out + add.float()
    return out.to(out_dtype)


def top1_plan(n: int, blocks: int) -> list[list[int]]:
    """K3's row groups of each warp: warp gw of the blocks x 8 takes groups
    gw, gw + W, ... (W = 8 blocks) of the ceil(n / 16); group r holds the
    vocabulary rows [16 r, 16 r + 16) (matmul.cu:top1_body)."""
    groups, warps = -(-n // 16), 8 * blocks
    return [list(range(gw, groups, warps)) for gw in range(warps)]


def _top1_merge(a, b, need_prob):
    """matmul.cu:top1_merge on (m, s, i) states (ties to the lowest index)."""
    (am, as_, ai), (bm, bs, bi) = a, b
    m = torch.maximum(am, bm)
    i = torch.where(am > bm, ai, torch.where(bm > am, bi,
                                             torch.minimum(ai, bi)))
    if not need_prob:
        return m, torch.zeros_like(m), i
    ninf = float("-inf")
    s = torch.where(am != ninf, as_ * torch.exp(am - m), 0.0) + torch.where(
        bm != ninf, bs * torch.exp(bm - m), 0.0)
    return m, s, i


def matmul_top1_emulated(a, w, *, final_cap, blocks: int, prologue_norm=None,
                         allowed_mask=None, need_prob=True):
    """K3 in its own order: the logits of the folded prologue's A, walked
    by `top1_plan` over `blocks` blocks, each lane's vocabulary rows g and
    g + 8 of its groups in increasing order into one online state a row
    of A; then the 8 lanes of a row (g xor 1, 2, 4), the warps of a block
    in order, and the blocks, lane l taking blocks l, l + 32, ..., then
    the butterfly (xor 1 .. 16).  Returns (token int32, prob f32) [M]."""
    if prologue_norm is not None:
        a = prenorm_fixed_order(a, prologue_norm)
    logits = _product_plain(a, w)
    m, n = logits.shape
    dev = logits.device
    warps = 8 * blocks
    groups = -(-n // 16)
    live = torch.ones(n, dtype=torch.bool, device=dev) \
        if allowed_mask is None else allowed_mask.bool().to(dev)
    capped = need_prob and final_cap != 0.0
    shape = (m, warps, 8)
    st = (torch.full(shape, float("-inf"), device=dev),
          torch.zeros(shape, device=dev),
          torch.full(shape, _INT_MAX, dtype=torch.int64, device=dev))
    gw = torch.arange(warps, device=dev)[:, None]
    g = torch.arange(8, device=dev)[None, :]
    for step in range(-(-groups // warps)):
        grp = gw + step * warps
        for h in (0, 1):
            col = 16 * grp + g + 8 * h
            ok = (grp < groups) & (col < n)
            colc = col.clamp(max=n - 1)
            ok = (ok & live[colc]).expand(shape)
            v = logits[:, colc]
            if capped:
                v = final_cap * torch.tanh(v / final_cap)
            sm, ss, si = st
            up = ok & (v > sm)
            if need_prob:
                grown = ss * torch.exp(sm - v) + 1.0
                ss = torch.where(up, grown,
                                 torch.where(ok, ss + torch.exp(v - sm), ss))
            st = (torch.where(up, v, sm), ss,
                  torch.where(up, col.expand(shape), si))
    for o in (1, 2, 4):  # lanes xor 4, 8, 16: g xor 1, 2, 4
        st = _top1_merge(st, tuple(x[..., g[0] ^ o] for x in st), need_prob)
    ws = tuple(x[..., 0].reshape(m, blocks, 8) for x in st)
    r = tuple(x[..., 0] for x in ws)
    for wi in range(1, 8):
        r = _top1_merge(r, tuple(x[..., wi] for x in ws), need_prob)
    pad = (-blocks) % 32
    lanes = (torch.full((m, 32), float("-inf"), device=dev),
             torch.zeros(m, 32, device=dev),
             torch.full((m, 32), _INT_MAX, dtype=torch.int64, device=dev))
    cols = tuple(torch.cat([x, torch.full((m, pad), fill, dtype=x.dtype,
                                          device=dev)], 1).reshape(m, -1, 32)
                 for x, fill in zip(r, (float("-inf"), 0.0, _INT_MAX)))
    for i in range(cols[0].shape[1]):
        lanes = _top1_merge(lanes, tuple(x[:, i] for x in cols), need_prob)
    idx = torch.arange(32, device=dev)
    for o in (1, 2, 4, 8, 16):
        lanes = _top1_merge(lanes, tuple(x[:, idx ^ o] for x in lanes),
                            need_prob)
    best, s, i = (x[:, 0] for x in lanes)
    token = torch.where(best == float("-inf"), 0, i).to(torch.int32)
    if not need_prob:
        return token, torch.ones_like(best)
    return token, 1.0 / s.clamp_min(1e-30)


_DEAD_KEY = (0x007FFFFF << 32) | 0x80000000  # (-inf, INT_MAX): an empty slot


def topk_keys(vals: np.ndarray, idxs: np.ndarray) -> np.ndarray:
    """K6's selection keys (matmul.cu:sel_key) as uint64: the f32 value's
    bits made monotone (-0.0 as +0.0) above the complement of the int32
    index, so that the keys' order is (value descending, index
    ascending)."""
    v = np.where(vals == 0, np.float32(0), vals).astype(np.float32)
    u = v.view(np.uint32)
    hi = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    lo = ~np.asarray(idxs, np.int32).view(np.uint32)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _key_entries(keys: np.ndarray):
    """(values f32, indices int32) of selection keys."""
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    u = np.where(hi & np.uint32(0x80000000), hi & np.uint32(0x7FFFFFFF), ~hi)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return u.view(np.float32), (~lo).view(np.int32)


SEL_THREADS = 256  # matmul.cu:kSelThreads


def _radix_kth(keys: np.ndarray, need: int):
    """matmul.cu:radix_kth: passes over 8-bit digits from the top, each a
    histogram of the digits among the keys that match `prefix` on `mask`,
    the bin where the count from the top reaches the keys still needed;
    done as soon as every key of that bin is taken.  Returns (prefix,
    mask, need)."""
    prefix = mask = 0
    for step in range(8):
        if need <= 0:
            break
        shift = 56 - 8 * step
        match = (keys & np.uint64(mask)) == np.uint64(prefix)
        hist = np.bincount(((keys[match] >> np.uint64(shift))
                            & np.uint64(255)).astype(np.int64),
                           minlength=256)
        above = 0
        for b in range(255, -1, -1):
            if above + hist[b] >= need:
                break
            above += hist[b]
        need -= above
        prefix |= b << shift
        mask |= 0xFF << shift
        if need == hist[b]:
            break
    return prefix, mask, need


def select_sorted_emulated(keys: np.ndarray, k_top: int) -> np.ndarray:
    """matmul.cu:select_sorted on one block's keys: the keys above the
    k_top-th key's prefix (`_radix_kth`) and those still needed of the ones
    that match it, padded with empty slots to k_top and sorted
    descending."""
    keys = np.asarray(keys, np.uint64)
    k_sel = min(k_top, len(keys))
    prefix, mask, need = _radix_kth(keys, k_sel)
    top = keys & np.uint64(mask)
    chosen = np.concatenate([keys[top > np.uint64(prefix)],
                             keys[top == np.uint64(prefix)][:need]])
    assert len(chosen) == k_sel
    chosen = np.concatenate([chosen, np.full(k_top - k_sel, _DEAD_KEY,
                                             np.uint64)])
    return np.sort(chosen)[::-1]


def block_topk_emulated(keys: np.ndarray, k_top: int) -> np.ndarray:
    """matmul.cu:block_topk: each of SEL_THREADS threads' largest key over
    entries t, t + SEL_THREADS, ... (0 for a thread with none); the prefix
    of the k_top-th largest of those maxima bounds the answer from below;
    select_sorted_emulated of the keys at or above it."""
    keys = np.asarray(keys, np.uint64)
    tmax = np.zeros(SEL_THREADS, np.uint64)
    for t in range(min(SEL_THREADS, len(keys))):
        tmax[t] = keys[t::SEL_THREADS].max()
    bound = np.uint64(_radix_kth(tmax, k_top)[0])
    return select_sorted_emulated(keys[keys >= bound], k_top)


def matmul_topk_emulated(a, w, k_top, *, final_cap=0.0, prologue_norm=None,
                         allowed_mask=None, slice_len: int = TOPK_SLICE):
    """K6 in its own order: the logits of the folded prologue's A (K3's
    stream writes each once), capped, masked columns -inf; per row, each
    slice of `topk_slices(N, slice_len)` selected by
    `block_topk_emulated`, the slices' lists round-tripped through (value,
    index) and selected once more when there are several.
    Returns (values f32, indices int32) [M, k_top], dead entries (-inf,
    0)."""
    if prologue_norm is not None:
        a = prenorm_fixed_order(a, prologue_norm)
    logits = _product_plain(a, w)
    if final_cap:
        logits = final_cap * torch.tanh(logits / final_cap)
    if allowed_mask is not None:
        logits = logits.masked_fill(~allowed_mask.bool(), float("-inf"))
    logits = logits.float().numpy()
    m, n = logits.shape
    vals = np.empty((m, k_top), np.float32)
    idxs = np.empty((m, k_top), np.int32)
    cols = np.arange(n, dtype=np.int32)
    for r in range(m):
        lists = [block_topk_emulated(
            topk_keys(logits[r, s.start:s.stop], cols[s.start:s.stop]), k_top)
            for s in topk_slices(n, slice_len)]
        if len(lists) > 1:
            v, i = _key_entries(np.concatenate(lists))
            lists = [block_topk_emulated(topk_keys(v, i), k_top)]
        v, i = _key_entries(lists[0])
        vals[r] = v
        idxs[r] = np.where(v == -np.inf, 0, i)
    return torch.from_numpy(vals), torch.from_numpy(idxs)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _b_operand(w: QuantTensor, name: str):
    """(codec, data ptr, x, y) of a weight as the kernels take it, x and y
    being the inv_scales and zeropoints pointers (i8), the scales and mins
    pointers (i4), the tables pointer and their row stride in bytes
    (nuq4), else None; raises on a kind or a shape the kernels do not
    take.  A stacked weight's pointers are those of layer 0, its group
    arrays [L, K/128, N]."""
    if w.kind not in _CODEC:
        raise unknown_kind(w.kind)
    codec = _CODEC[w.kind]
    if w.k % K_MULTIPLE[codec] or w.n % 8:
        raise ValueError(
            f"{name}: for kind {w.kind!r} K must be a multiple of "
            f"{K_MULTIPLE[codec]} and N of 8, got {w.shape}")
    dtype = {"i8": torch.int8, "sfp": torch.uint8, "bf16": torch.bfloat16,
             "f32": torch.float32, "i4": torch.uint8,
             "nuq4": torch.uint8}[codec]
    lead = (w.data().shape[0],) if w.stacked else ()
    packed = codec in PACKED_KINDS
    _cuda.check(w.data(), "weight", dtype,
                lead + ((w.n, w.k // 2) if packed else w.shape))
    if codec == "nuq4":
        tables = w.arrays["tables"]
        _cuda.check(tables, "tables", torch.uint8,
                    lead + (w.n, round_up(w.k // PACK_BLOCK * 16, 128)))
        return (codec, w.data().data_ptr(), tables.data_ptr(),
                tables.shape[-1])
    if codec not in ("i8", "i4"):
        return codec, w.data().data_ptr(), None, None
    mul, off = ("inv_scales", "zeropoints") if codec == "i8" \
        else ("scales", "mins")
    g = lead + ((w.k // GROUP, w.n) if w.stacked else (w.n, w.k // GROUP))
    _cuda.check(w.arrays[mul], mul, torch.float32, g)
    _cuda.check(w.arrays[off], off, torch.float32, g)
    return (codec, w.data().data_ptr(), w.arrays[mul].data_ptr(),
            w.arrays[off].data_ptr())


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (the
    kernels read these operands in 16-byte words)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _a_operand(a: torch.Tensor, k: int, prologue_norm, scratch=False):
    """(A, norm, scratch) as the kernel takes them: f32 A with a norm, else
    bf16 A; with `scratch`, a bf16 [M, K] scratch for a norm pass to write
    the normalized rows to (the prefill tile's entries)."""
    buf = None
    if prologue_norm is not None:
        _cuda.check(a, "a", torch.float32)
        _cuda.check(prologue_norm, "prologue_norm", torch.float32, (k,))
        if scratch:
            buf = torch.empty(a.shape, dtype=torch.bfloat16, device=a.device)
    else:
        _cuda.check(a, "a", torch.bfloat16)
    if a.ndim != 2 or a.shape[1] != k:
        raise ValueError(f"a must be [M, {k}], got {tuple(a.shape)}")
    return _aligned(a), _aligned(prologue_norm), buf


def _check_epilogue(weight, add, m, n):
    if weight is not None:
        _cuda.check(weight, "epilogue_norm", torch.float32, (n,))
    if add is not None:
        _cuda.check(add, "add", torch.float32, (m, n))


def _mask_operand(allowed_mask, n):
    """The [N] allowed mask as the head kernels read it (one byte each)."""
    if allowed_mask is None:
        return None
    allowed_mask = allowed_mask.to(torch.bool).contiguous()
    _cuda.check(allowed_mask, "allowed_mask", torch.bool, (n,))
    return allowed_mask


def prenorm(a, weight):
    """bf16(rmsnorm(a)) over whole rows: the prologue pass alone on CUDA."""
    if not a.is_cuda:
        return prenorm_plain(a, weight)
    a, weight, out = _a_operand(a, a.shape[-1], weight, scratch=True)
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
           epilogue_norm=None, layer: int | None = None):
    """C = add + postnorm(scale * A . W^T) (matmul.py:1015-1177).

    prologue_norm: RMSNorm weight [K] applied to A's rows in-kernel (A
    then arrives f32); epilogue_norm: post-RMSNorm weight [N] over the
    output rows; add: [M, N] residual, added after the post-norm;
    layer: for a stacked w, the layer to multiply by (K12 on CUDA)."""
    _check_layer(w, layer, "matmul")
    if not a.is_cuda:
        if layer is not None:
            w = take_layer(w, layer)
        return matmul_plain(a, w, out_dtype, add, prologue_norm,
                            epilogue_norm)
    return _matmul_cuda(a, w, out_dtype, add, prologue_norm, epilogue_norm,
                        layer)


def _matmul_cuda(a, w, out_dtype, add, prologue_norm, epilogue_norm, layer):
    """matmul's kernel path: checks, allocates and launches."""
    _, b_ptr, inv_ptr, zp_ptr = _b_operand(w, "matmul")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}")
    m = a.shape[0]
    decode = m <= DECODE_ROWS
    a, norm, a_scratch = _a_operand(a, w.k, prologue_norm,
                                    scratch=not decode)
    _check_epilogue(epilogue_norm, add, m, w.n)
    epilogue_norm, add = _aligned(epilogue_norm), _aligned(add)
    out = torch.empty(m, w.n, dtype=out_dtype, device=a.device)
    # f32 [M, N] of the raw product where a post-norm follows it: the
    # prefill tile's epilogue pass reads it (as the add pass does), the
    # decode tile's last block.
    post = epilogue_norm is not None or (add is not None and not decode)
    y = None
    if post:
        y = out if out_dtype == torch.float32 else torch.empty(
            m, w.n, dtype=torch.float32, device=a.device)
    kernel, layer_args = _gemm_kernel(
        m, w, layer, a.device, MATMUL, MATMUL_STACKED, MATMUL_SM90, False)
    if not decode:
        kernel.launch(
            a.data_ptr(), _cuda.ptr(norm), b_ptr, inv_ptr, zp_ptr,
            float(w.scale), *layer_args, _cuda.ptr(epilogue_norm),
            _cuda.ptr(add), _cuda.ptr(a_scratch), _cuda.ptr(y),
            out.data_ptr(), m, w.n, w.k, int(out_dtype == torch.bfloat16))
        return out
    ticket = slots = None
    if epilogue_norm is not None:
        kw, splits = layer_args[-2:]  # blocks: panels x splits
        blocks = -(-w.n // (DECODE_WARP_COLS[False] * (8 // kw))) * splits
        ticket, slots = _device_scratch(a.device, blocks * m)
    kernel.launch(
        a.data_ptr(), _cuda.ptr(norm), b_ptr, inv_ptr, zp_ptr,
        float(w.scale), *layer_args, _cuda.ptr(epilogue_norm),
        _cuda.ptr(add), _cuda.ptr(y), _cuda.ptr(slots), _cuda.ptr(ticket),
        out.data_ptr(), m, w.n, w.k, int(out_dtype == torch.bfloat16))
    return out


def matmul_top1(a, w, *, final_cap, prologue_norm=None, allowed_mask=None,
                need_prob=True):
    """(token int32 [M], prob f32 [M]) = Top1OfSoftmax(softcap(scale *
    A . W^T)) without the [M, N] logits (matmul.py:1640-1725, K3).

    allowed_mask: [N] bool, banned columns leave the argmax and the sum;
    prologue_norm: the final RMSNorm weight [K] (A then arrives f32);
    need_prob=False: raw-logits argmax, prob 1.0."""
    _check_layer(w, None, "matmul_top1")
    if not a.is_cuda:
        return matmul_top1_plain(a, w, final_cap=final_cap,
                                 prologue_norm=prologue_norm,
                                 allowed_mask=allowed_mask,
                                 need_prob=need_prob)
    return _top1_cuda(a, w, final_cap, prologue_norm, allowed_mask,
                      need_prob)


def _top1_cuda(a, w, final_cap, prologue_norm, allowed_mask, need_prob):
    """matmul_top1's kernel path: checks, allocates and launches."""
    codec, b_ptr, inv_ptr, zp_ptr = _b_operand(w, "matmul_top1")
    a, norm, _ = _a_operand(a, w.k, prologue_norm)
    m = a.shape[0]
    allowed_mask = _mask_operand(allowed_mask, w.n)
    ticket, _ = _device_scratch(a.device)
    part = torch.empty(2, m, TOP1_BLOCKS, dtype=torch.float32,
                       device=a.device)
    part_i = torch.empty(m, TOP1_BLOCKS, dtype=torch.int32, device=a.device)
    tok = torch.empty(m, dtype=torch.int32, device=a.device)
    prob = torch.empty(m, dtype=torch.float32, device=a.device)
    TOP1[codec].launch(
        a.data_ptr(), _cuda.ptr(norm), b_ptr, inv_ptr, zp_ptr,
        float(w.scale), float(final_cap), _cuda.ptr(allowed_mask),
        int(need_prob), part[0].data_ptr(), part[1].data_ptr(),
        part_i.data_ptr(), ticket.data_ptr(), tok.data_ptr(),
        prob.data_ptr(), m, w.n, w.k, TOP1_BLOCKS)
    return tok, prob


def topk_slices(n: int, slice_len: int = TOPK_SLICE) -> list[range]:
    """The entries of a row each block of K6's selection takes: slices of
    `slice_len` consecutive entries, the last one ragged."""
    return [range(lo, min(lo + slice_len, n))
            for lo in range(0, n, slice_len)]


def _select_scratch(m, n, k_top, device):
    """The selection's lists [M, slices, k_top] (values, indices), its
    slice count and the device's tickets; raises where the row's last
    block could not hold the lists."""
    slices = len(topk_slices(n))
    if slices * k_top > TOPK_MAX_MERGE:
        raise ValueError(f"top-k of {n} entries a row: {slices} slices of "
                         f"k_top {k_top} exceed {TOPK_MAX_MERGE}")
    part_v = torch.empty(m, slices, k_top, dtype=torch.float32,
                         device=device)
    part_i = torch.empty(m, slices, k_top, dtype=torch.int32, device=device)
    tickets, _ = _device_scratch(device, tickets=m)
    return part_v, part_i, slices, tickets


def topk_merge(part_v, part_i, k_top):
    """K6's selection alone on CUDA, as a merge: part_v f32 / part_i int32
    [M, blocks, k_top] -> the k_top best of each row by (value descending,
    index ascending), ([M, k_top]) x 2; dead entries (-inf) leave with
    index 0."""
    if not part_v.is_cuda:
        return topk_merge_plain(part_v, part_i, k_top)
    return _merge_cuda(part_v, part_i, k_top)


def _merge_cuda(part_v, part_i, k_top):
    """topk_merge's kernel path: checks, allocates and launches."""
    m, blocks, k = part_v.shape
    if k != k_top or not 1 <= k_top <= MAX_TOPK:
        raise ValueError(f"topk_merge: lists of {k}, k_top {k_top}")
    _cuda.check(part_v, "part_v", torch.float32)
    _cuda.check(part_i, "part_i", torch.int32, part_v.shape)
    vals = torch.empty(m, k_top, dtype=torch.float32, device=part_v.device)
    idxs = torch.empty(m, k_top, dtype=torch.int32, device=part_v.device)
    sv, si, slices, tickets = _select_scratch(m, blocks * k_top, k_top,
                                              part_v.device)
    TOPK_MERGE.launch(part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                      idxs.data_ptr(), m, blocks, k_top, sv.data_ptr(),
                      si.data_ptr(), tickets.data_ptr(), slices)
    return vals, idxs


def matmul_topk(a, w, k_top, *, final_cap=0.0, prologue_norm=None,
                allowed_mask=None):
    """(values f32 [M, k_top], indices int32 [M, k_top]) of the k_top
    largest softcapped logits, descending, ties to the lower index, without
    the [M, N] logits (matmul.py:1577-1637, K6).  Entries past the live
    columns are (-inf, index 0).

    k_top > 128 is composed, as in the JAX package, which leaves its kernel
    there too: the K1 head GEMM, the cap, the mask as NEG_INF, and a stable
    descending sort (real indices throughout, as lax.top_k gives)."""
    _check_layer(w, None, "matmul_topk")
    k_top = int(k_top)
    if not 1 <= k_top <= w.n:
        raise ValueError(f"matmul_topk: k_top {k_top} of {w.n} columns")
    if k_top > MAX_TOPK:
        from gemma_tpu_torch.ops.sampling import NEG_INF, top_k_sorted

        logits = soft_cap(final_cap, matmul(a, w,
                                            prologue_norm=prologue_norm))
        if allowed_mask is not None:
            logits = torch.where(allowed_mask.bool(), logits, NEG_INF)
        vals, idxs = top_k_sorted(logits, k_top)
        return vals.contiguous(), idxs.to(torch.int32).contiguous()
    if not a.is_cuda:
        return matmul_topk_plain(a, w, k_top, final_cap=final_cap,
                                 prologue_norm=prologue_norm,
                                 allowed_mask=allowed_mask)
    return _topk_cuda(a, w, k_top, final_cap, prologue_norm, allowed_mask)


def _topk_cuda(a, w, k_top, final_cap, prologue_norm, allowed_mask):
    """matmul_topk's kernel path: checks, allocates and launches the head
    (the final norm folded in, as K3's) and its selection."""
    codec, b_ptr, inv_ptr, zp_ptr = _b_operand(w, "matmul_topk")
    a, norm, _ = _a_operand(a, w.k, prologue_norm)
    m = a.shape[0]
    allowed_mask = _mask_operand(allowed_mask, w.n)
    logits = torch.empty(m, w.n, dtype=torch.float32, device=a.device)
    part_v, part_i, slices, tickets = _select_scratch(m, w.n, k_top,
                                                      a.device)
    vals = torch.empty(m, k_top, dtype=torch.float32, device=a.device)
    idxs = torch.empty(m, k_top, dtype=torch.int32, device=a.device)
    TOPK[codec].launch(
        a.data_ptr(), _cuda.ptr(norm), b_ptr, inv_ptr, zp_ptr,
        float(w.scale), float(final_cap), _cuda.ptr(allowed_mask), k_top,
        logits.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        tickets.data_ptr(), vals.data_ptr(), idxs.data_ptr(), m, w.n, w.k,
        TOPK_BLOCKS, slices)
    return vals, idxs


def gated_ffn(x, w1, w2, out_dtype=torch.bfloat16, prologue_norm=None,
              layer: int | None = None):
    """TwoMatMul analog: gelu_tanh(x . W1^T) * (x . W2^T) in one kernel
    (matmul.py:1789), with an optional pre-FFN norm prologue; layer: for
    stacked w1 and w2, the layer to multiply by (K12 on CUDA)."""
    _check_layer(w1, layer, "gated_ffn")
    _check_layer(w2, layer, "gated_ffn")
    if not x.is_cuda:
        if layer is not None:
            w1, w2 = take_layer(w1, layer), take_layer(w2, layer)
        return gated_ffn_plain(x, w1, w2, out_dtype, prologue_norm)
    return _gated_cuda(x, w1, w2, out_dtype, prologue_norm, layer)


def _gated_cuda(x, w1, w2, out_dtype, prologue_norm, layer):
    """gated_ffn's kernel path: checks, allocates and launches."""
    codec, b1, inv1, zp1 = _b_operand(w1, "gated_ffn")
    codec2, b2, inv2, zp2 = _b_operand(w2, "gated_ffn")
    if w1.shape != w2.shape or codec != codec2:
        raise ValueError(f"gated_ffn: {w1.kind} {w1.shape} vs "
                         f"{w2.kind} {w2.shape}")
    if out_dtype != torch.bfloat16:
        raise ValueError("gated_ffn emits bf16 on CUDA")
    m = x.shape[0]
    decode = m <= DECODE_ROWS
    x, norm, a_scratch = _a_operand(x, w1.k, prologue_norm,
                                    scratch=not decode)
    out = torch.empty(m, w1.n, dtype=torch.bfloat16, device=x.device)
    kernel, layer_args = _gemm_kernel(
        m, w1, layer, x.device, GATED, GATED_STACKED, GATED_SM90, True)
    scratch = () if decode else (_cuda.ptr(a_scratch),)
    kernel.launch(x.data_ptr(), _cuda.ptr(norm), b1, inv1, zp1,
                  float(w1.scale), b2, inv2, zp2, float(w2.scale),
                  *layer_args, *scratch, out.data_ptr(), m, w1.n, w1.k)
    return out
