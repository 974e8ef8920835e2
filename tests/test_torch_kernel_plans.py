"""The host-side plans of the port's kernels, which are pure Python and
run here: how ``decode_attention`` splits the cache over a cluster, how
``flash_attention`` tiles its grid, how ``ssd_scan`` splits P over blocks
and how many blocks ``monitor_combine`` launches.  The kernels themselves
run only on the card (tests/test_torch_cuda.py); their wrappers must
refuse CPU tensors rather than fall back."""
import math

import pytest
import torch

from repro_torch.configs import granite_8b, zamba2_7b
from repro_torch.core.decomposition import edge_arch
from repro_torch.kernels.decode_attention import (HEAD_DIMS as DECODE_DIMS,
                                                  MIN_SPLIT_ROWS, SPLITS,
                                                  TARGET_BLOCKS,
                                                  decode_attention_cuda,
                                                  decode_attention_split,
                                                  decode_plan, n_split)
from repro_torch.kernels.flash_attention import (HEAD_DIMS as FLASH_DIMS,
                                                 SMEM_LIMIT,
                                                 flash_attention_cuda,
                                                 flash_plan)
from repro_torch.kernels.monitor_combine import (MAX_BLOCKS, ONE_BLOCK_MAX,
                                                 THREADS as COMBINE_THREADS,
                                                 combine_blocks,
                                                 monitor_combine_blocks,
                                                 monitor_combine_cuda)
from repro_torch.kernels import ssm_scan
from repro_torch.kernels.ssm_scan import (REG_BLOCKS, SM_COUNT, SMEM_PER_SM,
                                          SMEM_RESERVED, THREADS,
                                          THREADS_PER_SM, TILES, ssd_plan,
                                          ssd_scan_cuda, ssd_scan_tiled,
                                          tile_smem_bytes)
from repro_torch.nn.ssm import ssm_dims


@pytest.mark.parametrize("B", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("Hkv", [1, 4, 8, 32])
@pytest.mark.parametrize("C", [1, 16, 32, 40, 100, 512, 1024, 4096])
def test_n_split_is_a_small_power_of_two_with_enough_rows(B, Hkv, C):
    n = n_split(B, Hkv, C)
    assert n in SPLITS
    # no split below MIN_SPLIT_ROWS rows, unless the cache is unsplit
    assert n == 1 or C // n >= MIN_SPLIT_ROWS
    # at least 2 where the rows allow it, and the least split from 2 up
    # that reaches TARGET_BLOCKS: halving it falls short of the target,
    # and doubling it is not allowed or not needed
    assert n >= 2 or C // 2 < MIN_SPLIT_ROWS
    if n > 2:
        assert B * Hkv * (n // 2) < TARGET_BLOCKS
    if n < SPLITS[-1] and C // (2 * n) >= MIN_SPLIT_ROWS:
        assert B * Hkv * n >= TARGET_BLOCKS


@pytest.mark.parametrize("tower,C,splits", [
    ("server", 512, 4),          # 8 x 8 (kv head, row) pairs: 256 blocks
    ("edge", 512, 8),            # 8 x 4 pairs: 256 blocks
    ("edge", 1024, 8),
    ("zamba2 shared", 512, 2),   # 8 x 32 pairs, at least 2: 512 blocks
])
def test_decode_plan_at_the_serve_shapes(tower, C, splits):
    full, zfull = granite_8b.FULL, zamba2_7b.FULL
    cfg = {"server": full, "edge": edge_arch(full),
           "zamba2 shared": zfull}[tower]
    B = 8
    plan = decode_plan(B, cfg.n_kv_heads, C)
    assert plan["splits"] == splits
    assert plan["clusters"] == B * cfg.n_kv_heads
    assert plan["blocks"] == B * cfg.n_kv_heads * splits
    assert plan["blocks"] >= TARGET_BLOCKS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", FLASH_DIMS)
def test_flash_plan_fits_the_card(dtype, D):
    plan = flash_plan(2, 4096, 32, D, dtype)
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["box_cols"] >= D and plan["box_cols"] % 32 == 0
    assert plan["query_tiles"] == math.ceil(4096 / plan["block_q"])
    assert plan["blocks"] == 2 * 32 * plan["query_tiles"]
    if dtype == torch.bfloat16:
        # two consumer warpgroups of 64 query rows and one producer warp;
        # whole 128-byte boxes of 64 columns; wgmma's N is 64 or 128
        assert plan["threads"] == 2 * 128 + 32
        assert plan["block_q"] == 128 and plan["box_cols"] % 64 == 0
        assert plan["block_k"] in (64, 128)
        # a consumer thread holds block_k/2 score and box_cols/2 output
        # floats: at most 128 of the 224 registers a thread of 288 gets
        assert plan["block_k"] // 2 + plan["box_cols"] // 2 <= 128


@pytest.mark.parametrize("S,tiles", [(1, 1), (128, 1), (129, 2), (191, 2),
                                     (4096, 32)])
def test_flash_plan_covers_ragged_rows(S, tiles):
    plan = flash_plan(1, S, 4, 128, torch.bfloat16)
    assert plan["query_tiles"] == tiles
    assert plan["query_tiles"] * plan["block_q"] >= S


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("splits", [None, 1, 8])
def test_decode_kernel_wrapper_refuses_cpu_tensors(splits):
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 32, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        if splits is None:
            decode_attention_cuda(q, k, k, 3)
        else:
            decode_attention_split(q, k, k, 3, splits)


def test_head_dims_agree_with_the_plans():
    # every head dim the flash wrapper takes has a bf16 tiling of whole
    # boxes, and the decode kernel takes each of them too
    for D in FLASH_DIMS:
        assert D in DECODE_DIMS
        assert flash_plan(1, 1, 1, D, torch.bfloat16)["box_cols"] in (64, 128)


# ------------------------------------------------------------- ssd_scan
@pytest.mark.parametrize("B,S,H", [(1, 1, 1), (2, 300, 6), (2, 4096, 112),
                                   (8, 2048, 64)])
@pytest.mark.parametrize("P", [16, 32, 48, 64])
@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("L", [16, 64, 128])
def test_ssd_plan_tiles_and_fits_the_card(B, S, H, P, N, L):
    plan = ssd_plan(B, S, H, P, N, L)
    pt = plan["pt"]
    assert pt in TILES and pt % 16 == 0 and P % pt == 0
    assert plan["blocks"] == P // pt * H * B
    assert plan["smem_bytes"] == tile_smem_bytes(pt, L, N) <= 232_448
    # blocks an SM follow from the shared bytes (each block also takes the
    # 1 KB the card reserves), the threads and the register budget
    assert plan["resident"] == min(
        SMEM_PER_SM // (plan["smem_bytes"] + SMEM_RESERVED),
        THREADS_PER_SM // THREADS, REG_BLOCKS[pt]) >= 1
    assert plan["rounds"] == math.ceil(plan["blocks"] / SM_COUNT)
    assert 0.0 <= plan["idle"] < 1.0
    # no tile that divides P costs less
    for other in TILES:
        if P % other == 0:
            rounds = math.ceil(P // other * H * B / SM_COUNT)
            assert plan["cost"] <= rounds * (other + ssm_scan.G_COLS)


def test_ssd_plan_at_the_hybrid_train_shape():
    """zamba2-7b's Mamba2 layers at the train cell's B = 2 x S = 4096: 64
    columns a block, 224 blocks of 92 KB, two an SM; the busiest SM runs
    two blocks, and 40 of the 132 SMs run one: 40 of 264 block slots
    idle."""
    from repro_torch.configs import zamba2_7b
    cfg = zamba2_7b.FULL
    _, H, P, N = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_state)
    plan = ssd_plan(2, 4096, H, P, N, cfg.ssm_chunk)
    assert (H, P, N, cfg.ssm_chunk) == (112, 64, 64, 128)
    assert plan["pt"] == 64 and plan["blocks"] == 224
    assert plan["smem_bytes"] == 92_160 and plan["resident"] == 2
    assert plan["rounds"] == 2
    assert plan["idle"] == pytest.approx(40 / 264)


@pytest.mark.parametrize("B,S,H,P,N,chunk,pt", [
    # tests/test_kernels.py:72-76: grids of one round, where more blocks
    # (the narrowest tile) finish first
    (2, 256, 4, 32, 16, 64, 16),
    (1, 128, 2, 64, 64, 128, 16),
    (2, 512, 8, 16, 32, 32, 16),
])
def test_ssd_plan_on_the_reference_grid(B, S, H, P, N, chunk, pt):
    plan = ssd_plan(B, S, H, P, N, chunk)
    assert plan["pt"] == pt and plan["rounds"] == 1


def test_ssd_plan_refuses_a_p_no_tile_divides():
    with pytest.raises(ValueError, match="divides"):
        ssd_plan(1, 128, 2, 40, 64, 128)


@pytest.mark.parametrize("pt", [None, *TILES])
def test_ssd_kernel_wrapper_refuses_cpu_tensors(pt):
    xdt = torch.zeros((1, 32, 2, 64))
    la, bc = torch.zeros((1, 32, 2)), torch.zeros((1, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        if pt is None:
            ssd_scan_cuda(xdt, la, bc, bc, chunk=32)
        else:
            ssd_scan_tiled(xdt, la, bc, bc, pt, chunk=32)


# ------------------------------------------------------- monitor_combine
@pytest.mark.parametrize("n", [1, 8, 100, ONE_BLOCK_MAX])
def test_combine_takes_one_block_up_to_its_threshold(n):
    """The serving paths combine one score per stream (N = B = 8): one
    block, which writes the counts itself, so no zeroed scratch."""
    assert combine_blocks(n) == 1


@pytest.mark.parametrize("n,blocks", [
    (ONE_BLOCK_MAX + 1, math.ceil((ONE_BLOCK_MAX + 1) / COMBINE_THREADS)),
    (100_000, math.ceil(100_000 / COMBINE_THREADS)),
    (2**20, MAX_BLOCKS),
])
def test_combine_spreads_larger_n_over_blocks(n, blocks):
    assert combine_blocks(n) == blocks


def test_combine_threshold_covers_the_serve_batch():
    assert ONE_BLOCK_MAX >= 8


@pytest.mark.parametrize("blocks", [None, 1, 4])
def test_combine_kernel_wrapper_refuses_cpu_tensors(blocks):
    u = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        if blocks is None:
            monitor_combine_cuda(u, u, u, s=0.2)
        else:
            monitor_combine_blocks(u, u, u, blocks, s=0.2)
