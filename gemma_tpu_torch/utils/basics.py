"""Integer helpers and the sampling stream shared by the port (counterpart
of gemma_tpu/utils/basics.py).

`sample_key(seed, qi, pos)` is the JAX package's
`fold_in(fold_in(PRNGKey(seed), qi), pos)`: Threefry-2x32 in integer
arithmetic, so a token's draw depends on (seed, query index, position)
alone, whatever the batch, the chunk size or the path that draws it
(the reference's RngStream, gemma/gemma.cc:470-477).  torch has no uint32
arithmetic; the words live in int64 tensors masked to 32 bits.  The key
words and `stream_bits` equal JAX's `jax.random.key_data` and
`jax.random.bits` bit for bit (jax_threefry_partitionable=True, the
default since JAX 0.5); `stream_uniform` equals `jax.random.uniform`.
"""

from __future__ import annotations

import torch

# Reference: gemma/tokenizer.h:29 (BOS_ID = 2).
BOS_ID = 2


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _as_words(x, device=None) -> torch.Tensor:
    """x (int or integer tensor) as int64 words in [0, 2^32)."""
    t = torch.as_tensor(x, device=device).to(torch.int64)
    return t & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011, as jax.random's
    default PRNG runs it): int64 tensors holding 32-bit words, broadcast
    against each other.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def sample_key(seed: int, qi, pos) -> torch.Tensor:
    """The stream key of (seed, query, position): int64 [..., 2] holding
    two 32-bit words, on the device of `qi`/`pos` when they are tensors.
    Equals jax.random.key_data(fold_in(fold_in(PRNGKey(seed), qi), pos))."""
    device = next((x.device for x in (qi, pos)
                   if isinstance(x, torch.Tensor)), None)
    qi, pos = _as_words(qi, device), _as_words(pos, device)
    seed = int(seed)
    # The seed's words stay Python ints: no host-to-device copy, so the
    # derivation can run inside a CUDA graph capture.
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k0, k1 = threefry2x32((seed >> 32) & _M32, seed & _M32, zero, qi)
    k0, k1 = threefry2x32(k0, k1, zero, pos)
    return torch.stack(torch.broadcast_tensors(k0, k1), dim=-1)


def stream_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """n 32-bit words of the stream `key` [..., 2]: int64 [..., n], lane j
    being the xor of the two Threefry words of counter (0, j), as
    jax.random.bits(key, (n,)) draws them."""
    lane = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(lane), lane)
    return b0 ^ b1


def stream_uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """n uniforms in [0, 1) of the stream `key`: the top 23 bits of each
    word as an f32 mantissa, f32 [..., n] (jax.random.uniform)."""
    bits = (stream_bits(key, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
