"""K13, the nuq4 gather diagnostic (gemma_tpu_torch/ops/nuq_diag.py): its
plain version against the JAX script's Pallas kernel `kern`
(scripts/proto_nuq_diag.py:26), run in interpret mode on the CPU through a pallas_call built here with the specs of its `run`
(:64-83), at M=16, K=2304, N=512 with full-K tiles.

Both sides form exact bf16 products (D1 and D2 codes, and D3's tables
rounded to bf16, are exact in bf16) and sum them in f32 in another order:
1e-5 of max|out| bounds the difference."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gemma_tpu_torch.ops import nuq_diag as diag
from gemma_tpu_torch.scripts.proto_nuq_diag import make_inputs
from scripts.proto_nuq_diag import kern
from tests.test_torch_matmul import rel_err

torch.set_num_threads(1)

M, K, N = 16, 2304, 512
BM, BN, BK = 16, 512, 2304


def jax_run(a, codes, tables, variant):
    """scripts/proto_nuq_diag.py:run's pallas_call, in interpret mode."""
    grid = (M // BM, N // BN, K // BK)
    tl = tables.shape[1]
    return pl.pallas_call(
        functools.partial(kern, variant, grid[2], BK),
        grid=grid,
        in_specs=[
            pl.BlockSpec((BM, BK), lambda i, j, kk: (i, kk)),
            pl.BlockSpec((BN, BK), lambda i, j, kk: (j, kk)),
            pl.BlockSpec((BN, tl), lambda i, j, kk: (j, 0)),
        ],
        out_specs=pl.BlockSpec((BM, BN), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        scratch_shapes=[pltpu.VMEM((BM, BN), jnp.float32)],
        interpret=True,
    )(a, codes, tables)


def inputs(variant, seed):
    """bf16 A, u8 codes (the script's pre-offset 4-bit codes for D3, all
    256 byte values for D1 / D2, so that codes of 128 and above show
    where int8 and i32 part), f32 tables [N, 256]."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (M, K)).astype(np.float32)
    a = np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    if variant == "D3":
        codes4 = rng.integers(0, 16, (N, K)).astype(np.uint8)
        offs = (16 * ((np.arange(K) // 256) % 8)).astype(np.uint8)
        codes = codes4 + offs[None, :]
    else:
        codes = rng.integers(0, 256, (N, K)).astype(np.uint8)
    tables = rng.random((N, 256)).astype(np.float32)
    return a, codes, tables


@pytest.mark.parametrize("variant", diag.VARIANTS)
def test_run_plain_matches_jax_kern(variant):
    a, codes, tables = inputs(variant, {"D1": 1, "D2": 2, "D3": 3}[variant])
    want = jax_run(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(codes),
                   jnp.asarray(tables), variant)
    t_a = torch.from_numpy(a).to(torch.bfloat16)
    t_codes, t_tables = torch.from_numpy(codes), torch.from_numpy(tables)
    got = diag.run_plain(t_a, t_codes, t_tables, variant)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert rel_err(got, np.asarray(want)) <= 1e-5
    # On the CPU `run` is the plain version.
    assert torch.equal(diag.run(t_a, t_codes, t_tables, variant), got)


def test_d1_and_d2_part_at_codes_of_128_and_above():
    a, codes, tables = inputs("D1", 4)
    t_a = torch.from_numpy(a).to(torch.bfloat16)
    low = torch.from_numpy(codes & 127)
    assert torch.equal(diag.run_plain(t_a, low, None, "D1"),
                       diag.run_plain(t_a, low, None, "D2"))
    high = torch.from_numpy(codes | 128)
    b1 = diag.b_operand(high, None, "D1").float()
    b2 = diag.b_operand(high, None, "D2").float()
    assert torch.equal(b2 - b1, torch.full_like(b1, 256.0))


def test_make_inputs_gives_codes_below_128():
    a, codes, tables = make_inputs(M, K, N, "cpu")
    assert a.dtype == torch.bfloat16 and codes.dtype == torch.uint8
    assert int(codes.max()) < 128 and tables.shape == (N, 256)
    assert diag.run(a, codes, tables, "D3").shape == (M, N)
