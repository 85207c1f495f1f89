"""KV cache (counterpart of gemma_tpu/models/kv_cache.py; reference
gemma/kv_cache.{h,cc}).

Up to two pools per cache:

    kv:       [batch, n_global_layers, 2, kv_heads, s_alloc, qkv_dim]
    kv_local: [batch, n_local_layers,  2, kv_heads, s_alloc_local, qkv_dim]

Sliding-window layers get rings of window + local_slack rows (the slack
keeps a prefill chunk's writes off rows earlier queries of the same
chunk still attend to); a uniform-window config degenerates to the one
global pool.  Ring row = pos % ring; one extra garbage row at `ring`
absorbs writes from padded slots; rows pad to 32 for i8 (16 otherwise).
kind "i8" stores codes with per-(b, layer, k/v, head, row) f32 scales in

    kv_scale: [batch, n_layers, 2, kv_heads, 1, s_alloc]

The pools are updated in place: the prefill scatter here and the decode
kernels (ops/decode_attention.py) write rows into the existing tensors
rather than building new ones, which saves a copy of the cache per
layer and step (the JAX package needs donation to get the same effect).
"""

from __future__ import annotations

import dataclasses

import torch

from gemma_tpu_torch.models.configs import ModelConfig
from gemma_tpu_torch.ops.kv_quant import dequantize_rows, quantize_rows
from gemma_tpu_torch.utils.basics import resolve_device, round_up

LOCAL_RING_SLACK = 256

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "i8": torch.int8}


@dataclasses.dataclass
class KVCache:
    kv: torch.Tensor                 # global pool
    seq_len: int                     # global ring length
    kv_local: torch.Tensor | None = None
    seq_len_local: int = 0
    # layer_idx -> (is_local, index within its pool)
    layer_map: tuple = ()
    local_slack: int = 0
    kv_scale: torch.Tensor | None = None
    kv_local_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.kv_scale is not None

    def pool(self, layer_idx: int) -> tuple[torch.Tensor, int, int]:
        """(pool tensor, index within the pool, ring length)."""
        if not self.layer_map:
            return self.kv, layer_idx, self.seq_len
        is_local, idx = self.layer_map[layer_idx]
        if is_local:
            return self.kv_local, idx, self.seq_len_local
        return self.kv, idx, self.seq_len

    def pool_scale(self, layer_idx: int) -> torch.Tensor | None:
        if self.kv_scale is None:
            return None
        if self.layer_map and self.layer_map[layer_idx][0]:
            return self.kv_local_scale
        return self.kv_scale

    @property
    def batch(self) -> int:
        return self.kv.shape[0]

    @property
    def s_alloc(self) -> int:
        """Rows of the global pool: ring, garbage row and padding."""
        return self.kv.shape[4]

    @property
    def garbage_row(self) -> int:
        return self.seq_len  # first row past the global ring

    @classmethod
    def create(cls, config: ModelConfig, batch: int,
               seq_len: int | None = None, kind: str = "bf16",
               split_local: bool = True,
               local_slack: int = LOCAL_RING_SLACK,
               device: str | torch.device | None = None) -> "KVCache":
        """Zeroed pools on `device` (CUDA unless the caller names one)."""
        device = resolve_device(device)
        dtype = _DTYPES[kind]
        quant = kind == "i8"
        lc = config.layer_configs[0]
        seq_len = min(seq_len or config.max_seq_len, config.max_seq_len)
        n_layers = len(config.layer_configs)
        windows = list(config.attention_window_sizes)
        local_windows = [w for w in windows if w < seq_len]
        use_local = (split_local and local_windows
                     and max(local_windows) + local_slack < seq_len)
        tile = 32 if quant else 16

        def alloc(n, ring):
            return torch.zeros(batch, n, 2, lc.kv_heads,
                               round_up(ring + 1, tile), lc.qkv_dim,
                               dtype=dtype, device=device)

        def alloc_scale(n, ring):
            if not quant:
                return None
            return torch.zeros(batch, n, 2, lc.kv_heads, 1,
                               round_up(ring + 1, tile), dtype=torch.float32,
                               device=device)

        if not use_local:
            return cls(alloc(n_layers, seq_len), seq_len,
                       kv_scale=alloc_scale(n_layers, seq_len))
        seq_local = max(local_windows) + local_slack
        layer_map = []
        gi = li = 0
        for w in windows:
            if w < seq_len:
                layer_map.append((True, li))
                li += 1
            else:
                layer_map.append((False, gi))
                gi += 1
        return cls(alloc(gi, seq_len), seq_len, alloc(li, seq_local),
                   seq_local, tuple(layer_map), local_slack,
                   alloc_scale(gi, seq_len), alloc_scale(li, seq_local))

    def copy(self) -> "KVCache":
        cp = lambda a: None if a is None else a.clone()  # noqa: E731
        return dataclasses.replace(
            self, kv=self.kv.clone(), kv_local=cp(self.kv_local),
            kv_scale=cp(self.kv_scale), kv_local_scale=cp(self.kv_local_scale))

    def k_layer(self, layer_idx: int) -> torch.Tensor:
        """[batch, kv_heads, s_alloc, qkv_dim] keys (dequantized for i8)."""
        return self._panel(layer_idx, 0)

    def v_layer(self, layer_idx: int) -> torch.Tensor:
        return self._panel(layer_idx, 1)

    def _panel(self, layer_idx: int, kv: int) -> torch.Tensor:
        pool, idx, _ = self.pool(layer_idx)
        if not self.quantized:
            return pool[:, idx, kv]
        return dequantize_rows(pool[:, idx, kv],
                               self.pool_scale(layer_idx)[:, idx, kv, :, 0])

    def update(self, layer_idx: int, positions: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor | None = None) -> None:
        """Write k/v rows at ring positions, in place (the prefill scatter;
        the JAX package leaves it to an XLA scatter, so it stays plain).

        positions [B, T]; k, v [B, T, KVH, D]; valid [B, T] bool sends
        invalid slots to the garbage row."""
        pool, idx, ring = self.pool(layer_idx)
        rows = torch.remainder(positions.long(), ring)
        if valid is not None:
            rows = torch.where(valid, rows, torch.full_like(rows, ring))
        b, t = rows.shape
        new = torch.stack([k, v], dim=1)  # [B, 2, T, KVH, D]
        bi = torch.arange(b, device=pool.device)[:, None].expand(b, t)
        if self.quantized:
            codes, scale = quantize_rows(new)  # [B,2,T,KVH,D], [B,2,T,KVH]
            sc = self.pool_scale(layer_idx)
            for kv in range(2):
                # [B, KVH, 1, S] viewed at (b, row) -> [B, T, KVH]
                sc[:, idx, kv, :, 0].permute(0, 2, 1)[bi, rows] = scale[:, kv]
            new = codes
        for kv in range(2):
            # pool[:, idx, kv] is [B, KVH, S, D]; index (b, row) over [B, S].
            pool[:, idx, kv].permute(0, 2, 1, 3)[bi, rows] = \
                new[:, kv].to(pool.dtype)
