"""The launch plan of the port's ``int8_matmul`` kernel, on the CPU.

``ops/cuda/matmul_int8.py::_plan`` picks the column tile, the row tile,
the thread-block cluster that splits K and the K-rows of each cluster
rank; ``csrc/int8_matmul.cu`` derives every index from it.  These tests
walk the kernel's index arithmetic (grid, threads, row groups, x tiles)
in Python and check that every output column, every x row and every
K-row is covered exactly once, at the flagship's shapes and at ragged
ones.  The kernel itself runs only on the GPU (``test_torch_cuda.py``).
"""

import itertools

import numpy as np
import pytest

from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm

#: threads a block of csrc/int8_matmul.cu (kThreads)
THREADS = 256

FLAGSHIP = [(m, k, n) for m in (1, 8)
            for k, n in ((768, 3072), (3072, 768), (768, 32768))]
RAGGED = list(itertools.product((1, 3, 8, 9, 16, 17, 40), (1, 100, 4097),
                                (1, 15, 17, 3000)))


def _walk(plan, M, K, N):
    """Times each column, x row and K-row is visited by the kernel's
    index arithmetic under ``plan`` (grid (cluster, ceil(N / block_n),
    ceil(M / row_tile)), 256 threads a block)."""
    tpr = plan.block_n // plan.vec
    groups = THREADS // tpr
    tile_k = tmm._TILE_FLOATS // plan.row_tile
    cols = np.zeros(N, int)
    for y in range(-(-N // plan.block_n)):
        for cq in range(tpr):
            n0 = y * plan.block_n + cq * plan.vec
            cols[n0:min(N, n0 + plan.vec)] += 1
    rows = np.zeros(M, int)
    for z in range(-(-M // plan.row_tile)):
        rows[z * plan.row_tile:min(M, (z + 1) * plan.row_tile)] += 1
    ks = np.zeros(K, int)
    for rank in range(plan.cluster):
        k_begin = rank * plan.k_chunk
        k_end = min(K, k_begin + plan.k_chunk)
        assert k_begin < k_end, f"rank {rank} of {plan} has no K-rows"
        for k0 in range(k_begin, k_end, tile_k):
            k1 = min(k_end, k0 + tile_k)
            for rg in range(groups):
                ks[k0 + rg:k1:groups] += 1
    return cols, rows, ks


@pytest.mark.parametrize("sm_count", [16, 132])
@pytest.mark.parametrize("M,K,N", FLAGSHIP + RAGGED)
def test_plan_covers_every_column_row_and_k_row_once(M, K, N, sm_count):
    plan = tmm._plan(M, K, N, sm_count)
    assert plan.row_tile in (1, 4, 8)
    assert plan.row_tile >= min(M, 8)       # one row tile up to M = 8
    tpr = plan.block_n // plan.vec
    assert plan.block_n % plan.vec == 0 and tpr in (2, 4, 8)
    assert 1 <= plan.cluster <= tmm._MAX_CLUSTER
    assert plan.cluster * plan.k_chunk >= K
    grid = (plan.cluster, -(-N // plan.block_n), -(-M // plan.row_tile))
    assert all(g >= 1 for g in grid) and max(grid[1:]) <= 65535
    cols, rows, ks = _walk(plan, M, K, N)
    assert (cols == 1).all() and (rows == 1).all() and (ks == 1).all()


@pytest.mark.parametrize("M,K,N", FLAGSHIP)
def test_plan_fills_the_card_at_the_flagship_shapes(M, K, N):
    """At least two thirds of a block a SM.  At one row, the widest
    column tile whose tiles alone reach that, if any; else the widest
    tile that reaches it split over a cluster of 8, and K split only as
    far as needed."""
    target = 2 * 132 // 3
    plan = tmm._plan(M, K, N, 132)

    def tiles(block_n):
        return -(-N // block_n) * -(-M // plan.row_tile)

    assert plan.cluster * tiles(plan.block_n) >= target
    widest = plan.block_n == 8 * plan.vec
    if plan.cluster == 1 and plan.row_tile == 1:
        assert widest or tiles(2 * plan.block_n) < target
    else:
        assert tiles(plan.block_n) < target or plan.cluster == 1
        assert widest or tiles(2 * plan.block_n) * 8 < target


def test_plan_splits_k_over_a_cluster_where_columns_are_few():
    """w1 (768 x 3072) at M=1: 96 tiles of 32 columns, no split; w2
    (3072 x 768): 12 tiles of 64, K split 8 ways in one cluster, 384
    K-rows a rank; the 32768-column head: 256 tiles of 128, no split; at
    M=8, w1 splits K 2 ways over 48 tiles of 64; a K of 4097 at M=8
    takes the largest cluster and loops over x tiles."""
    assert tmm._plan(1, 768, 3072, 132) == tmm.Plan(32, 1, 1, 768)
    assert tmm._plan(1, 3072, 768, 132) == tmm.Plan(64, 1, 8, 384)
    assert tmm._plan(1, 768, 32768, 132) == tmm.Plan(128, 1, 1, 768)
    assert tmm._plan(8, 768, 3072, 132) == tmm.Plan(64, 8, 2, 384)
    big = tmm._plan(8, 4097, 17, 132)
    assert big.cluster == 8 and big.k_chunk > tmm._TILE_FLOATS // 8
