"""The launch plans of the codebook matmuls (kernel rows 1 and 11), chosen
on the host (``kernels/codebook_matmul_packed.py: plan``), pinned without a
card: at every qwen1.5-0.5b and deepseek-v2-lite-16b projection shape the
packed and uint8 routes give at M = 1, 4, 64 and 256, a plan launches at
least one block per SM of an H100 (132) and never splits K past its steps.
No JAX, no card.
"""
import pytest

from repro_torch.configs import get_config
from repro_torch.kernels.codebook_matmul import STEP_ROWS, uint8_plan
from repro_torch.kernels.codebook_matmul_packed import (DECODE_COLS,
                                                        DECODE_MAX_M,
                                                        MAX_SPLITS, TC_COLS,
                                                        TC_ROWS, packed_plan,
                                                        plan, step_rows,
                                                        tc_smem_bytes)

H100_SMS = 132


def projection_shapes(arch: str):
    """(Kd, N) of every projection of ``arch`` that a packed or uint8
    matmul serves."""
    c = get_config(arch)
    if c.mla is None:
        qkv = c.n_heads * c.head_dim
        return [(c.d_model, qkv), (c.d_model, c.n_kv * c.head_dim),
                (qkv, c.d_model), (c.d_model, c.d_ff), (c.d_ff, c.d_model)]
    a, moe = c.mla, c.moe
    shared = moe.n_shared * moe.d_ff_expert
    return [(c.d_model, c.n_heads * (a.nope_dim + a.rope_dim)),
            (c.d_model, a.kv_lora + a.rope_dim),
            (a.kv_lora, c.n_heads * a.nope_dim),
            (a.kv_lora, c.n_heads * a.v_dim),
            (c.n_heads * a.v_dim, c.d_model),
            (c.d_model, c.d_ff), (c.d_ff, c.d_model),
            (c.d_model, shared), (shared, c.d_model)]


CASES = [(arch, m) for arch in ("qwen1.5-0.5b", "deepseek-v2-lite-16b")
         for m in (1, 4, 64, 256)]


def _check(p, m, kd, n, load_rows, step):
    assert 1 <= p.splits <= MAX_SPLITS
    assert p.blocks >= H100_SMS, (m, kd, n, p)
    if m <= DECODE_MAX_M:
        assert p.tile == 0
        assert p.splits <= load_rows
        assert p.blocks == -(-n // DECODE_COLS) * p.splits
    else:
        assert p.tile in TC_COLS
        assert p.splits <= -(-kd // step)
        assert p.blocks == (-(-m // TC_ROWS) * -(-n // p.tile) * p.splits)


@pytest.mark.parametrize("arch,m", CASES)
@pytest.mark.parametrize("k", [2, 16, 256])
def test_packed_plan_fills_the_card(arch, m, k):
    bits = max(1, (k - 1).bit_length())
    for kd, n in projection_shapes(arch):
        p = packed_plan(m, kd, n, k, H100_SMS)
        _check(p, m, kd, n, -(-kd // (32 // bits)), step_rows(bits))


@pytest.mark.parametrize("arch,m", CASES)
def test_uint8_plan_fills_the_card(arch, m):
    for kd, n in projection_shapes(arch):
        _check(uint8_plan(m, kd, n, H100_SMS), m, kd, n, kd, STEP_ROWS)


@pytest.mark.parametrize("bits", range(1, 9))
def test_step_rows_are_whole_word_rows_of_whole_k8_steps(bits):
    rows = step_rows(bits)
    assert rows % 8 == 0 and rows % (32 // bits) == 0 and rows >= 32
    assert rows < 32 + 8 * (32 // bits)
    # every tensor-core block fits an SM's shared memory, two at 32 columns
    for cols in TC_COLS:
        smem = tc_smem_bytes(rows, cols, rows // (32 // bits) * (cols + 8) * 4,
                             1 << bits)
        assert smem <= 227 * 1024 and (cols == 64 or 2 * smem <= 227 * 1024)


def test_plans_at_the_timed_shapes():
    """The plans chip_smoke.py times at qwen's w_gate (Kd 1024, N 2816)."""
    assert tuple(packed_plan(4, 1024, 2816, 16, H100_SMS)) == (0, 2, 176)
    # three 64 x 64 blocks fit an SM: one wave of 352, not two of 528
    assert tuple(packed_plan(64, 1024, 2816, 16, H100_SMS)) == (64, 8, 352)
    assert tuple(packed_plan(256, 1024, 2816, 16, H100_SMS)) == (64, 2, 352)
    # too few 64-column tiles to fill the card: 32 columns
    assert tuple(packed_plan(64, 1024, 1024, 16, H100_SMS)) == (32, 8, 256)
    # a small grid: K split over the SMs, never past its one step
    assert tuple(plan(1, 8, 32, load_rows=1, step=32,
                      sm_count=H100_SMS)) == (0, 1, 1)
    assert tuple(plan(40, 30, 32, load_rows=1, step=32,
                      sm_count=H100_SMS)) == (64, 1, 1)
