"""The host-side plans of the port's two attention kernels, which are pure
Python and run here: how ``decode_attention`` splits the cache over a
cluster, and how ``flash_attention`` tiles its grid.  The kernels
themselves run only on the card (tests/test_torch_cuda.py); their
wrappers must refuse CPU tensors rather than fall back."""
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
