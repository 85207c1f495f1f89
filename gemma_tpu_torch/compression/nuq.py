"""NUQ: non-uniform 4-bit quantization codec.

Stream format (compression/nuq-inl.h:616-657 `NuqCodec::Enc`,
types.h:128-188): values are grouped in chunks of GROUP_SIZE=256 along the
flat (row-major, unpadded) element order.  Each group occupies 144 bytes:

    [16 bytes]  CLUSTERS=16 cluster centers, ascending, SFP8-encoded
    [128 bytes] 256 4-bit indices, two per byte, LOW nibble first

(~4.5 bits/value).  NOTE: types.h:119-122's comment describing "all tables
first" is stale -- the shipped encoder interleaves the table with each
group's indices via TableByteOffset (nuq-inl.h:534-539), which is what we
implement.

The encoder is optimal 1-D k-means (squared L2) per group via dynamic
programming on the sorted values with O(1) interval costs from cumulative
sums (nuq-inl.h:52-380, after https://arxiv.org/abs/1701.07204):

  cost(first, last) = sum2 - mu * (2*sum - mu*len),  mu = sum/len

Cluster centers are the interval means, then SFP8-rounded for storage.
Groups shorter than 256 are padded with the group max so no cluster is
wasted on a sentinel (nuq-inl.h:263-273).  If fewer than 16 clusters are
used, the unused low cluster slots hold 0.0 and indices start above them.

The reference ships no golden NUQ byte patterns (nuq_test.cc is
property-based), so our tests check layout invariants, round-trip SNR on the
same distributions, and optimality of the clustering on small cases.

`to_device_layout` returns the device layout: per-(row, 256-block) tables +
u8 codes for table-lookup dequantization inside the GEMM kernels (see
ops/matmul.py).  A copy of gemma_tpu/compression/nuq.py's numpy paths; the
JAX package's optional C encoder (compression/nuq_native.py) is not
carried, so clustering always runs in numpy (seconds per 10^5 values).
"""

from __future__ import annotations

import numpy as np

from gemma_tpu_torch.compression import sfp

CLUSTERS = 16
GROUP_SIZE = 256
GROUP_BYTES = CLUSTERS + GROUP_SIZE // 2  # 144


def packed_end(num_values: int) -> int:
    """Total stream bytes for `num_values` (types.h:180-184)."""
    num_groups = -(-num_values // GROUP_SIZE)
    return CLUSTERS * num_groups + -(-num_values // 2)


def _cluster_group(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Optimal 1-D k-means of one group; returns (centers[16], indices[256]).

    Mirrors NuqClustering::ClusterExactL2 (nuq-inl.h:246-380) BIT-EXACTLY
    (verified against the reference's own binary in tests/test_ref_parity.py):

    * Sort keys carry the original index in the low 8 mantissa bits
      (FloatPayload, nuq-inl.h:58-77), so values that differ only in those
      bits order by index, and the cost/center sums use the payload-CLEARED
      (truncated) values.
    * Partial groups are padded to 256 with the raw max value; indices are
      returned for ALL 256 positions -- the dead trailing nibble of an odd
      remainder holds the first padding element's cluster, as the reference
      writes it (nuq-inl.h:673-685).
    * The DP cost table is computed in f32 with the reference's exact
      operation order (f32 prefix sums narrowed from a running double,
      reciprocal multiply, separate mul/sub/add roundings -- the baseline
      non-FMA target semantics, matching the parity-harness build).
      Centers use the double prefix sums (dcumsum_, nuq-inl.h:92-101).
    """
    num = x.shape[0]
    assert 0 < num <= GROUP_SIZE
    x = np.ascontiguousarray(x, dtype=np.float32)
    if num < GROUP_SIZE:
        # Pad with the max so the padding joins an existing cluster
        # (nuq-inl.h:262-272).
        x = np.concatenate(
            [x, np.full(GROUP_SIZE - num, x.max(), np.float32)])
    n = GROUP_SIZE

    # FloatPayload::Set: clear low 8 mantissa bits, OR in the index.
    bits = x.view(np.uint32)
    keys = ((bits & np.uint32(~np.uint32(n - 1)))
            | np.arange(n, dtype=np.uint32)).view(np.float32)
    sort_perm = np.argsort(keys, kind="stable")  # all keys distinct
    sorted_keys = keys[sort_perm]
    order = (sorted_keys.view(np.uint32) & np.uint32(n - 1)).astype(np.int64)
    # Payload-cleared sorted values: the quantities every sum sees.
    clean = (sorted_keys.view(np.uint32)
             & np.uint32(~np.uint32(n - 1))).view(np.float32)

    # Prefix sums: a running double, narrowed to f32 per element for the
    # cost table (cumsum_/cumsum2_), kept double for centers (dcumsum_).
    dcsum = np.zeros(n + 1)
    np.cumsum(clean.astype(np.float64), out=dcsum[1:])
    dcsum2 = np.zeros(n + 1)
    np.cumsum(clean.astype(np.float64) ** 2, out=dcsum2[1:])
    csum = dcsum.astype(np.float32)
    csum2 = dcsum2.astype(np.float32)

    # cost[f, l] in f32, reference operation order (SumCosts,
    # nuq-inl.h:149-174): mu = sum * (1/len); l2 = mu*(mu*len - 2*sum) + sum2
    # with each step rounded separately (no FMA on the baseline target).
    first_idx = np.arange(n, dtype=np.int64)[:, None]
    last_idx = np.arange(n, dtype=np.int64)[None, :]
    length = (last_idx - first_idx + 1).astype(np.float32)
    valid = length > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_len = (np.float32(1.0) / length).astype(np.float32)
        seg_sum = (csum[last_idx + 1] - csum[first_idx]).astype(np.float32)
        seg_sum2 = (csum2[last_idx + 1]
                    - csum2[first_idx]).astype(np.float32)
        mu = (seg_sum * inv_len).astype(np.float32)
        two_sum = (seg_sum + seg_sum).astype(np.float32)
        t = ((mu * length).astype(np.float32) - two_sum).astype(np.float32)
        cost = ((mu * t).astype(np.float32) + seg_sum2).astype(np.float32)
    cost = np.where(cost < 0, np.float32(0.0), cost)  # ZeroIfNegative
    cost = np.where(valid, cost, np.float32(np.inf))

    # costs[k, l] = min cost of clustering sorted[0..l] into k+1 clusters,
    # accumulated in f32 like the reference's AlignedMatrix<float>.
    costs = np.empty((CLUSTERS, n), dtype=np.float32)
    argmin = np.zeros((CLUSTERS, n), dtype=np.int64)
    costs[0] = cost[0]
    for k in range(1, CLUSTERS):
        # candidate[f, l] = costs[k-1, f-1] + cost[f, l] for f in [1, l].
        cand = (costs[k - 1, :-1][:, None] + cost[1:, :]).astype(np.float32)
        best = np.argmin(cand, axis=0)  # first minimum, like strict-Lt scan
        best_cost = cand[best, np.arange(n)]
        keep_prev = costs[k - 1] <= best_cost  # ties keep the k-1 solution
        costs[k] = np.where(keep_prev, costs[k - 1], best_cost)
        argmin[k] = np.where(keep_prev, argmin[k - 1], best + 1)

    # Backtrack cluster boundaries (nuq-inl.h:327-357).
    centers = np.zeros(CLUSTERS, dtype=np.float32)
    indices_sorted = np.zeros(n, dtype=np.uint8)
    last = n - 1
    for k in range(CLUSTERS - 1, -1, -1):
        start = int(argmin[k, last])
        # Center = double-precision mean of the truncated values.
        centers[k] = np.float32((dcsum[last + 1] - dcsum[start])
                                / (last - start + 1))
        indices_sorted[start : last + 1] = k
        if start == 0:
            break
        last = start - 1

    indices = np.zeros(n, dtype=np.uint8)
    indices[order] = indices_sorted
    return centers, indices


def encode(values: np.ndarray) -> np.ndarray:
    """Encode flat f32 values into a NUQ byte stream (uint8[packed_end])."""
    flat = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    num = flat.shape[0]
    num_groups = -(-num // GROUP_SIZE)
    out = np.zeros(packed_end(num), dtype=np.uint8)
    for g in range(num_groups):
        lo, hi = g * GROUP_SIZE, min((g + 1) * GROUP_SIZE, num)
        centers, idx = _cluster_group(flat[lo:hi])
        base = g * GROUP_BYTES
        out[base : base + CLUSTERS] = sfp.encode(centers)
        # Two 4-bit indices per byte, low nibble first (NibbleCodec order);
        # idx covers all 256 positions so an odd remainder's dead nibble
        # matches the reference stream byte-for-byte.
        nib = (idx[0::2] | (idx[1::2] << 4)).astype(np.uint8)
        n_bytes = -(-(hi - lo) // 2)
        out[base + CLUSTERS : base + CLUSTERS + n_bytes] = nib[:n_bytes]
    return out


def decode(stream: np.ndarray, num_values: int) -> np.ndarray:
    """Decode a NUQ byte stream back to f32 values."""
    stream = np.asarray(stream, dtype=np.uint8)
    num_groups = -(-num_values // GROUP_SIZE)
    out = np.empty(num_values, dtype=np.float32)
    for g in range(num_groups):
        base = g * GROUP_BYTES
        table = sfp.decode(stream[base : base + CLUSTERS])
        g_num = min(num_values - g * GROUP_SIZE, GROUP_SIZE)
        nib = np.zeros(GROUP_SIZE // 2, dtype=np.uint8)
        n_bytes = -(-g_num // 2)
        nib[:n_bytes] = stream[base + CLUSTERS : base + CLUSTERS + n_bytes]
        idx = np.empty(GROUP_SIZE, dtype=np.uint8)
        idx[0::2] = nib & 0xF
        idx[1::2] = nib >> 4
        out[g * GROUP_SIZE : g * GROUP_SIZE + g_num] = table[idx[:g_num]]
    return out


def to_sfp_codes(stream: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Expand NUQ to one SFP byte per value: codes[n,k] = the SFP-encoded
    center of that element's cluster.

    EXACT: NUQ tables store centers as SFP bytes (nuq-inl.h:649-651), so
    replacing each 4-bit index with its center's byte loses nothing.  This is
    kind "nuq"'s layout: the GEMMs then reuse the SFP bit-arithmetic
    dequant instead of a 16-way table lookup, at one byte a value instead
    of 0.5625 (see ops/matmul.py).
    """
    stream = np.asarray(stream, dtype=np.uint8)
    num = rows * cols
    num_groups = -(-num // GROUP_SIZE)
    grp_tables = np.zeros((num_groups, CLUSTERS), dtype=np.uint8)
    idx = np.zeros(num_groups * GROUP_SIZE, dtype=np.uint8)
    for g in range(num_groups):
        base = g * GROUP_BYTES
        grp_tables[g] = stream[base : base + CLUSTERS]
        g_num = min(num - g * GROUP_SIZE, GROUP_SIZE)
        n_bytes = -(-g_num // 2)
        nib = np.zeros(GROUP_SIZE // 2, dtype=np.uint8)
        nib[:n_bytes] = stream[base + CLUSTERS : base + CLUSTERS + n_bytes]
        idx[g * GROUP_SIZE : g * GROUP_SIZE + GROUP_SIZE : 2] = nib & 0xF
        idx[g * GROUP_SIZE + 1 : (g + 1) * GROUP_SIZE : 2] = nib >> 4
    group_of = np.arange(num) // GROUP_SIZE
    codes = grp_tables[group_of, idx[:num]]
    return codes.reshape(rows, cols)


def to_device_layout(
    stream: np.ndarray, rows: int, cols: int
) -> tuple[np.ndarray, np.ndarray]:
    """Convert a flat NUQ stream into the GEMMs' table-lookup layout.

    Returns (tables, codes):
      tables: f32 [rows, ceil(cols/256), 16]  per-(row, k-block) LUT
      codes:  u8  [rows, cols]                 4-bit index per value

    If cols % 256 == 0 the on-disk groups align with (row, k-block) and this
    is a pure repack.  Otherwise (e.g. Gemma3 model_dim 1152) groups span row
    boundaries on disk, so we decode and re-encode per aligned block; the
    re-clustering is the same optimal k-means, so quality is preserved (the
    cross-entropy oracle covers this end to end).
    """
    num = rows * cols
    if cols % GROUP_SIZE == 0:
        stream = np.asarray(stream, dtype=np.uint8)
        g_per_row = cols // GROUP_SIZE
        grp = stream[: rows * g_per_row * GROUP_BYTES].reshape(
            rows, g_per_row, GROUP_BYTES
        )
        tables = sfp.decode(grp[:, :, :CLUSTERS])
        nib = grp[:, :, CLUSTERS:]
        codes = np.empty((rows, g_per_row, GROUP_SIZE), dtype=np.uint8)
        codes[:, :, 0::2] = nib & 0xF
        codes[:, :, 1::2] = nib >> 4
        return tables.astype(np.float32), codes.reshape(rows, cols)

    values = decode(stream, num).reshape(rows, cols)
    g_per_row = -(-cols // GROUP_SIZE)
    tables = np.zeros((rows, g_per_row, CLUSTERS), dtype=np.float32)
    codes = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for g in range(g_per_row):
            lo, hi = g * GROUP_SIZE, min((g + 1) * GROUP_SIZE, cols)
            centers, idx = _cluster_group(values[r, lo:hi])
            tables[r, g] = sfp.decode(sfp.encode(centers))
            codes[r, lo:hi] = idx[: hi - lo]  # idx covers all 256 positions
    return tables, codes
